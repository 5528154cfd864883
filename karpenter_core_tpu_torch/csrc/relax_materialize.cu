// K18: the relax family's materializer, cells to node slots.
//
// Replaces relax_core's :321-401 (karpenter_core_tpu/relax/kernel.py): each
// audited cell's whole nodes at its template's per-node intake,
//
//   ppg = clip(per_pod[c, tstar, i], 1, 1e6); ncell = (n_ok // ppg) * ppg
//   nodes = ncell // ppg; cum = inclusive int32 prefix over the C * S groups
//   used_slots = min(sum nodes, N); placed_g = min(ncell, clip(N - offs, 0,
//   nodes) * ppg); leftover[c] = max(count[c] - sum_s placed_g, 0)
//
// and one slot row per node n < used_slots: its group g = searchsorted(cum,
// n, right), a = clip(ncell[g] - (n - offs[g]) * ppg[g], 0, ppg[g]) pods of
// class c_s on template t_s in zone z_s, with the merged requirement rows,
// the zone one-hot, the allowed capacity types, viable = feas[c_s, t_s, :,
// z_s] & per_pod >= a and used = fma(a, requests[c_s], daemon[t_s]) (XLA's
// FMA); every other slot closed, as a cold scan leaves it.  Ports are all
// false (eligible classes bind none).
//
// Bound on the H100: bytes.  At the headline it writes the N = 8,192 slot
// rows (viable 8 MB, the merged masks and the [C, N] assignment, about
// 9 MB: 2.7 us at 3.35 TB/s).  Design: launch 1 is one block of 1,024
// threads over the 48,000 groups (a contiguous chunk a thread, the
// chunk totals scanned in shared memory; int32 sums are exact in any
// order), which also forms placed, spilled, the per-class placed sums and
// leftover; launch 2 runs one block a slot: thread 0 finds the slot's group
// by binary search, then the block writes the slot's rows (coalesced over
// the instance types) and its column of the assignment.
// Float arithmetic is spelled with the _rn intrinsics (one FMA, XLA's).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kSlotThreads = 128;
constexpr int kPpCap = 1000000;

__device__ __forceinline__ int wrap_mul(int a, int b) {  // int32 product, wrapping
  return (int)((unsigned int)a * (unsigned int)b);
}

__global__ void __launch_bounds__(kThreads) materialize_groups_kernel(
    int n_c, int n_s, int n_t, int n_i, int n_z, int n_slots, const int32_t* __restrict__ n_ok,
    const int32_t* __restrict__ tstar, const int32_t* __restrict__ per_pod,
    const int32_t* __restrict__ count, int32_t* __restrict__ cum, int32_t* __restrict__ ncell,
    int32_t* __restrict__ ppg, int32_t* __restrict__ placed_c, int32_t* __restrict__ leftover,
    int32_t* __restrict__ scalars) {
  __shared__ int s_tot[kThreads];
  __shared__ int s_a[kThreads];
  __shared__ int s_b[kThreads];
  const long long n_g = (long long)n_c * n_s;
  const int chunk = (int)((n_g + kThreads - 1) / kThreads);
  const int lo = min((long long)threadIdx.x * chunk, n_g);
  const int hi = min((long long)lo + chunk, n_g);
  for (int c = threadIdx.x; c < n_c; c += blockDim.x) placed_c[c] = 0;
  int local = 0;
  for (int g = lo; g < hi; ++g) {
    const int c = g / n_s, s = g - (g / n_s) * n_s;
    const int t = tstar[g];
    const int pp = per_pod[((size_t)c * n_t + t) * n_i + s / n_z];
    const int p = min(max(pp, 1), kPpCap);
    const int nc = wrap_mul(n_ok[g] / p, p);
    ncell[g] = nc;
    ppg[g] = p;
    local = (int)((unsigned int)local + (unsigned int)(nc / p));
  }
  s_tot[threadIdx.x] = local;
  __syncthreads();
  if (threadIdx.x == 0) {  // exclusive prefix of the chunk totals
    unsigned int run = 0;
    for (int k = 0; k < kThreads; ++k) {
      const unsigned int v = (unsigned int)s_tot[k];
      s_tot[k] = (int)run;
      run += v;
    }
    scalars[3] = (int)run;  // total nodes
  }
  __syncthreads();
  const int total = scalars[3];
  const int used_slots = min(total, n_slots);
  unsigned int run = (unsigned int)s_tot[threadIdx.x];
  int placed_sum = 0, ncell_sum = 0;
  for (int g = lo; g < hi; ++g) {
    const int p = ppg[g], nc = ncell[g], nodes = nc / p;
    run += (unsigned int)nodes;
    cum[g] = (int)run;
    const int offs = (int)(run - (unsigned int)nodes);
    const int avail = min(max((int)((unsigned int)n_slots - (unsigned int)offs), 0), nodes);
    const int pg = min(nc, wrap_mul(avail, p));
    placed_sum = (int)((unsigned int)placed_sum + (unsigned int)pg);
    ncell_sum = (int)((unsigned int)ncell_sum + (unsigned int)nc);
    if (pg != 0) atomicAdd(placed_c + g / n_s, pg);
  }
  s_a[threadIdx.x] = placed_sum;
  s_b[threadIdx.x] = ncell_sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned int a = 0, b = 0;
    for (int k = 0; k < kThreads; ++k) {
      a += (unsigned int)s_a[k];
      b += (unsigned int)s_b[k];
    }
    scalars[0] = used_slots;
    scalars[1] = (int)a;
    scalars[2] = (int)(b - a);
  }
  for (int c = threadIdx.x; c < n_c; c += blockDim.x)
    leftover[c] = max((int)((unsigned int)count[c] - (unsigned int)placed_c[c]), 0);
}

struct SlotArgs {
  int n_c, n_s, n_t, n_i, n_z, n_ct, n_keys, n_words, n_res, n_slots;
  const int32_t* cum;
  const int32_t* ncell;
  const int32_t* ppg;
  const int32_t* scalars;
  const int32_t* tstar;
  const int32_t* per_pod;
  const int32_t* kmask_m;
  const uint8_t* kdef_m;
  const uint8_t* kneg_m;
  const float* kgt_m;
  const float* klt_m;
  const uint8_t* t_ct;
  const uint8_t* feas;
  const float* daemon;
  const float* requests;
  const int32_t* kmask0;
  int32_t* assign;
  float* used;
  int32_t* kmask;
  uint8_t* kdef;
  uint8_t* kneg;
  float* kgt;
  float* klt;
  uint8_t* zone;
  uint8_t* ct;
  uint8_t* viable;
  int32_t* pod_count;
  int32_t* tmpl_id;
  uint8_t* open_;
};

__global__ void __launch_bounds__(kSlotThreads) materialize_slots_kernel(SlotArgs p) {
  __shared__ int s_sel, s_a, s_c, s_t, s_z;
  const int n = blockIdx.x;
  if (threadIdx.x == 0) {
    const int n_g = p.n_c * p.n_s;
    int lo = 0, hi = n_g;  // the number of cum entries <= n
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (p.cum[mid] <= n) lo = mid + 1; else hi = mid;
    }
    const int g = min(max(lo, 0), n_g - 1);
    const int used_slots = p.scalars[0];
    const bool sel = n < used_slots;
    const int pg = p.ppg[g], nc = p.ncell[g];
    const int offs = (int)((unsigned int)p.cum[g] - (unsigned int)(nc / pg));
    const int rank = (int)((unsigned int)n - (unsigned int)offs);
    const int a = sel ? min(max((int)((unsigned int)nc - (unsigned int)wrap_mul(rank, pg)), 0), pg)
                      : 0;
    const int c = g / p.n_s;
    const int s = g - c * p.n_s;
    s_sel = sel;
    s_a = a;
    s_c = c;
    s_t = p.tstar[g];
    s_z = s - (s / p.n_z) * p.n_z;
  }
  __syncthreads();
  const bool sel = s_sel != 0;
  const int a = s_a, c = s_c, t = s_t, z = s_z;
  const size_t ct_row = (size_t)c * p.n_t + t;
  for (int r = threadIdx.x; r < p.n_res; r += blockDim.x)
    p.used[(size_t)n * p.n_res + r] =
        sel ? __fmaf_rn((float)a, p.requests[(size_t)c * p.n_res + r],
                        p.daemon[(size_t)t * p.n_res + r])
            : 0.0f;
  const int kw = p.n_keys * p.n_words;
  for (int k = threadIdx.x; k < kw; k += blockDim.x)
    p.kmask[(size_t)n * kw + k] = sel ? p.kmask_m[ct_row * kw + k] : p.kmask0[k % p.n_words];
  for (int k = threadIdx.x; k < p.n_keys; k += blockDim.x) {
    const size_t src = ct_row * p.n_keys + k, dst = (size_t)n * p.n_keys + k;
    p.kdef[dst] = sel && p.kdef_m[src];
    p.kneg[dst] = sel && p.kneg_m[src];
    p.kgt[dst] = sel ? p.kgt_m[src] : -INFINITY;
    p.klt[dst] = sel ? p.klt_m[src] : INFINITY;
  }
  for (int k = threadIdx.x; k < p.n_z; k += blockDim.x)
    p.zone[(size_t)n * p.n_z + k] = !sel || k == z;
  for (int k = threadIdx.x; k < p.n_ct; k += blockDim.x)
    p.ct[(size_t)n * p.n_ct + k] = !sel || p.t_ct[ct_row * p.n_ct + k];
  for (int i = threadIdx.x; i < p.n_i; i += blockDim.x)
    p.viable[(size_t)n * p.n_i + i] =
        !sel || (p.feas[(ct_row * p.n_i + i) * p.n_z + z] && p.per_pod[ct_row * p.n_i + i] >= a);
  for (int cc = threadIdx.x; cc < p.n_c; cc += blockDim.x)
    p.assign[(size_t)cc * p.n_slots + n] = (sel && cc == c) ? a : 0;
  if (threadIdx.x == 0) {
    p.pod_count[n] = a;
    p.tmpl_id[n] = sel ? t : 0;
    p.open_[n] = sel && a > 0;
  }
}

}  // namespace

extern "C" int kc_relax_materialize(
    int n_c, int n_t, int n_i, int n_z, int n_ct, int n_keys, int n_words, int n_res,
    int n_slots, const void* n_ok, const void* tstar, const void* per_pod, const void* count,
    const void* kmask_m, const void* kdef_m, const void* kneg_m, const void* kgt_m,
    const void* klt_m, const void* t_ct, const void* feas, const void* daemon,
    const void* requests, const void* kmask0, void* assign, void* used, void* kmask,
    void* kdef, void* kneg, void* kgt, void* klt, void* zone, void* ct, void* viable,
    void* pod_count, void* tmpl_id, void* open_, void* leftover, void* scalars, void* scratch,
    void* stream_p) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_p);
  const long long n_s = (long long)n_i * n_z;
  const long long n_g = n_s * n_c;
  if (n_c <= 0 || n_t <= 0 || n_s <= 0 || n_slots <= 0 || n_g >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  int32_t* cum = static_cast<int32_t*>(scratch);
  int32_t* ncell = cum + n_g;
  int32_t* ppg = ncell + n_g;
  int32_t* placed_c = ppg + n_g;
  // scalars: [n_next, placed, spilled, total nodes]
  materialize_groups_kernel<<<1, kThreads, 0, stream>>>(
      n_c, (int)n_s, n_t, n_i, n_z, n_slots, static_cast<const int32_t*>(n_ok),
      static_cast<const int32_t*>(tstar), static_cast<const int32_t*>(per_pod),
      static_cast<const int32_t*>(count), cum, ncell, ppg, placed_c,
      static_cast<int32_t*>(leftover), static_cast<int32_t*>(scalars));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  SlotArgs p;
  p.n_c = n_c;
  p.n_s = (int)n_s;
  p.n_t = n_t;
  p.n_i = n_i;
  p.n_z = n_z;
  p.n_ct = n_ct;
  p.n_keys = n_keys;
  p.n_words = n_words;
  p.n_res = n_res;
  p.n_slots = n_slots;
  p.cum = cum;
  p.ncell = ncell;
  p.ppg = ppg;
  p.scalars = static_cast<const int32_t*>(scalars);
  p.tstar = static_cast<const int32_t*>(tstar);
  p.per_pod = static_cast<const int32_t*>(per_pod);
  p.kmask_m = static_cast<const int32_t*>(kmask_m);
  p.kdef_m = static_cast<const uint8_t*>(kdef_m);
  p.kneg_m = static_cast<const uint8_t*>(kneg_m);
  p.kgt_m = static_cast<const float*>(kgt_m);
  p.klt_m = static_cast<const float*>(klt_m);
  p.t_ct = static_cast<const uint8_t*>(t_ct);
  p.feas = static_cast<const uint8_t*>(feas);
  p.daemon = static_cast<const float*>(daemon);
  p.requests = static_cast<const float*>(requests);
  p.kmask0 = static_cast<const int32_t*>(kmask0);
  p.assign = static_cast<int32_t*>(assign);
  p.used = static_cast<float*>(used);
  p.kmask = static_cast<int32_t*>(kmask);
  p.kdef = static_cast<uint8_t*>(kdef);
  p.kneg = static_cast<uint8_t*>(kneg);
  p.kgt = static_cast<float*>(kgt);
  p.klt = static_cast<float*>(klt);
  p.zone = static_cast<uint8_t*>(zone);
  p.ct = static_cast<uint8_t*>(ct);
  p.viable = static_cast<uint8_t*>(viable);
  p.pod_count = static_cast<int32_t*>(pod_count);
  p.tmpl_id = static_cast<int32_t*>(tmpl_id);
  p.open_ = static_cast<uint8_t*>(open_);
  materialize_slots_kernel<<<n_slots, kSlotThreads, 0, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}
