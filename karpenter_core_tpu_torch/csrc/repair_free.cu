// K10: the warm repair's eviction free.
//
// Replaces `_repair_free_impl` (karpenter_core_tpu/ops/solve.py:1960): the
// pods evicted since the carry was taken give back their capacity, pod
// counts and topology-group counts, on the new slots and on the existing
// nodes.  For every column n of either side (a new slot or an existing
// node), with free[c, n] the pods of class c evicted from it:
//
//   used[n, r]   -= sum_c free[c, n] * req[c, r]
//   pod_count[n]  = max(pod_count[n] - sum_c free[c, n], 0)
//   fwd[g, n]     = max(fwd[g, n] - sum_c member[c, g] * free[c, n], 0)
//   inv[g, n]     = max(inv[g, n] - sum_c own_inv[c, g] * free[c, n], 0)
//
// Requirement masks, zone and capacity-type commitments, ports and volume
// counters are not reverted (the reference's one-way pessimism).
//
// Bound on the H100: bytes.  At the headline tick (C = 16, N = 8,192,
// R = 3, G1 = 8, E = 1) it reads the two free planes (0.5 MB), the carry's
// used, pod counts and four topology planes and writes the same planes:
// about 1.3 MB, 0.4 us at 3.35 TB/s, far below a launch's latency.
// Design: ONE launch, one thread per column of both sides (threads past N
// take the existing nodes), each looping over the classes; consecutive
// threads read consecutive columns of every [C, N] and [G1, N] plane.
//
// Arithmetic matches the reference and the plain twin bit for bit: the f32
// sum is XLA's CPU dot behind the reference's einsum, from 0, one fused
// multiply-add a class, classes ascending (`__fmaf_rn`), then `__fsub_rn`
// from the usage.  int32 sums wrap as the reference's do (unsigned
// arithmetic), in any order.
//
// K21, `kc_repair_free_inplace`, replaces `repair_free_donated` (ops/solve.py:
// 2012, the same body with the carry donated): the same kernel with each
// output pointer equal to its input pointer, so the carry's used, pod_count,
// fwd_* and inv_* planes are freed where they lie and no full-width plane is
// allocated.  That aliasing is legal because each element is read and then
// written by one thread only, and because no pointer of `Side` carries
// `__restrict__`: keep it so.  `req`, `member` and `own_inv` are restrict
// and are never carry planes.  Same bytes, same bound, same order of the
// f32 sum as K10.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// No member is `__restrict__`: K21 passes each output equal to its input.
struct Side {
  int cols;
  const int32_t* free_;       // [C, cols]
  const float* used;          // [cols, R]
  const int32_t* pod_count;   // [cols]
  const int32_t* fwd;         // [G1, cols]
  const int32_t* inv;         // [G1, cols]
  float* used_out;
  int32_t* pod_count_out;
  int32_t* fwd_out;
  int32_t* inv_out;
};

__device__ __forceinline__ int32_t sub_floor0(int32_t a, uint32_t b) {
  const int32_t d = static_cast<int32_t>(static_cast<uint32_t>(a) - b);
  return d > 0 ? d : 0;
}

__global__ void __launch_bounds__(kThreads) repair_free_kernel(
    int n_cls, int n_res, int g1, const float* __restrict__ req,
    const int32_t* __restrict__ member, const int32_t* __restrict__ own_inv,
    Side new_side, Side ex_side) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  const bool is_new = j < new_side.cols;
  if (!is_new) j -= new_side.cols;
  const Side s = is_new ? new_side : ex_side;
  if (j >= s.cols) return;
  const int cols = s.cols;

  for (int r = 0; r < n_res; ++r) {
    float sum = 0.0f;
    for (int c = 0; c < n_cls; ++c) {
      const float f = static_cast<float>(s.free_[(size_t)c * cols + j]);
      sum = __fmaf_rn(f, req[c * n_res + r], sum);
    }
    s.used_out[(size_t)j * n_res + r] = __fsub_rn(s.used[(size_t)j * n_res + r], sum);
  }
  uint32_t freed = 0;
  for (int c = 0; c < n_cls; ++c) {
    freed += static_cast<uint32_t>(s.free_[(size_t)c * cols + j]);
  }
  s.pod_count_out[j] = sub_floor0(s.pod_count[j], freed);
  for (int g = 0; g < g1; ++g) {
    uint32_t fwd_sub = 0, inv_sub = 0;
    for (int c = 0; c < n_cls; ++c) {
      const uint32_t f = static_cast<uint32_t>(s.free_[(size_t)c * cols + j]);
      fwd_sub += static_cast<uint32_t>(member[c * g1 + g]) * f;
      inv_sub += static_cast<uint32_t>(own_inv[c * g1 + g]) * f;
    }
    const size_t at = (size_t)g * cols + j;
    s.fwd_out[at] = sub_floor0(s.fwd[at], fwd_sub);
    s.inv_out[at] = sub_floor0(s.inv[at], inv_sub);
  }
}

}  // namespace

extern "C" int kc_repair_free(
    int n_new, int n_ex, int n_cls, int n_res, int g1, const void* req, const void* member,
    const void* own_inv, const void* free_new, const void* used_new, const void* pod_count_new,
    const void* fwd_new, const void* inv_new, const void* free_ex, const void* used_ex,
    const void* pod_count_ex, const void* fwd_ex, const void* inv_ex, void* used_new_out,
    void* pod_count_new_out, void* fwd_new_out, void* inv_new_out, void* used_ex_out,
    void* pod_count_ex_out, void* fwd_ex_out, void* inv_ex_out, void* stream) {
  const int total = n_new + n_ex;
  if (total <= 0) return 0;
  const Side new_side{n_new,
                      static_cast<const int32_t*>(free_new),
                      static_cast<const float*>(used_new),
                      static_cast<const int32_t*>(pod_count_new),
                      static_cast<const int32_t*>(fwd_new),
                      static_cast<const int32_t*>(inv_new),
                      static_cast<float*>(used_new_out),
                      static_cast<int32_t*>(pod_count_new_out),
                      static_cast<int32_t*>(fwd_new_out),
                      static_cast<int32_t*>(inv_new_out)};
  const Side ex_side{n_ex,
                     static_cast<const int32_t*>(free_ex),
                     static_cast<const float*>(used_ex),
                     static_cast<const int32_t*>(pod_count_ex),
                     static_cast<const int32_t*>(fwd_ex),
                     static_cast<const int32_t*>(inv_ex),
                     static_cast<float*>(used_ex_out),
                     static_cast<int32_t*>(pod_count_ex_out),
                     static_cast<int32_t*>(fwd_ex_out),
                     static_cast<int32_t*>(inv_ex_out)};
  const int blocks = (total + kThreads - 1) / kThreads;
  repair_free_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      n_cls, n_res, g1, static_cast<const float*>(req), static_cast<const int32_t*>(member),
      static_cast<const int32_t*>(own_inv), new_side, ex_side);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int kc_repair_free_inplace(
    int n_new, int n_ex, int n_cls, int n_res, int g1, const void* req, const void* member,
    const void* own_inv, const void* free_new, void* used_new, void* pod_count_new,
    void* fwd_new, void* inv_new, const void* free_ex, void* used_ex, void* pod_count_ex,
    void* fwd_ex, void* inv_ex, void* stream) {
  return kc_repair_free(n_new, n_ex, n_cls, n_res, g1, req, member, own_inv, free_new,
                        used_new, pod_count_new, fwd_new, inv_new, free_ex, used_ex,
                        pod_count_ex, fwd_ex, inv_ex, used_new, pod_count_new, fwd_new,
                        inv_new, used_ex, pod_count_ex, fwd_ex, inv_ex, stream);
}
