// K1: instance-type viability and per-type capacity for every node slot.
//
// Replaces, in karpenter_core_tpu/ops/solve.py, the jnp program that
// `_phase` (:717-725), `committal_block` (:1127-1133, :1143-1161) and the
// template sweeps (:799-808, :1228-1233) build from `_it_intersects` (:334),
// `_offering_ok` (:402) and `_capacity` (:386):
//
//   it_ok[n,i]  = viable[n,i] & cls_it[i] & Intersects(merged[n], it[i])
//                 & some offering of i in node n's zone x capacity-type set
//   cap_ni[n,i] = it_ok ? min_r floor((alloc[i,r] - used[n,r] + 1e-4)
//                                    / max(size[r], 1e-9))   (BIG if size 0)
//                       : 0
//   cap_n[n]    = max_i cap_ni[n,i]
//
// Bound on the H100: bytes.  At the main path's N=8192 slots x I=1000 types
// it reads viable (8 MB) and writes it_ok (8 MB) and cap_ni (32 MB): about
// 48 MB, 14 us at 3.35 TB/s.  The per-type planes (masks, bounds, offerings,
// allocatable: a few tens of KB) stay in L1/L2 and are read by every row.
// Eight coalesced tenants move eight times that: about 384 MB, 115 us.
// Tenant axis: every operand may carry a leading tenant axis B (the
// coalesced multi-tenant solve stacks B clusters' planes); blockIdx.y is the
// tenant and every operand is read at that tenant's base offset — the
// catalog, templates and vocabulary included, since tenants that share a
// shape bucket may hold different values.  Only the vocabulary word mask
// and the per-key bounds flags are shared (they follow from the bucket's
// shapes).  A solo call is the same kernel at B = 1.
// Design: one block per slot row; the row's own planes are read once into
// registers by every thread (a broadcast load), the threads stride over the
// types so the byte and int32 stores coalesce, and the row maximum is a
// block reduction in shared memory, written by thread 0 — no second pass.
// Keys that cannot fail (undefined on one side, or negative on both) are
// skipped before any word or bound work.
//
// Arithmetic matches the reference bit for bit:
//  - the divide is IEEE round-to-nearest (`__fdiv_rn`; the library is built
//    without --use_fast_math), or floor() lands one off at exact multiples;
//  - float-to-int32 saturates as XLA's convert does: a class whose requests
//    are all zero gets BIG = 1e30, which must become INT_MAX, not INT_MIN;
//  - mask words are int32 and bits are tested with `&`, never `>>`;
//  - infinite Gt/Lt bounds run through ceil(lt) - floor(gt) - 1 as IEEE
//    infinities, giving the same unbounded range count.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kBig = 1e30f;
constexpr int kMaxR = 16;  // resources per row held in registers

__device__ __forceinline__ int sat_i32(float x) {
  // x >= 0 here (clamped above); XLA converts out-of-range floats to the
  // nearest representable int32
  return x >= 2147483648.0f ? 2147483647 : static_cast<int>(x);
}

__device__ __forceinline__ bool bit_set(int32_t word, int b) {
  return (word & static_cast<int32_t>(1u << b)) != 0;
}

__global__ void __launch_bounds__(kThreads) it_capacity_kernel(
    int n_rows, int n_types, int n_keys, int n_words, int n_vocab, int other_word,
    int other_bitpos, int n_res, int n_zones, int n_ct,
    const uint8_t* __restrict__ viable,      // [N, I]
    const uint8_t* __restrict__ cls_it,      // [I]
    const int32_t* __restrict__ a_mask,      // [N, K, W]
    const uint8_t* __restrict__ a_def,       // [N, K]
    const uint8_t* __restrict__ a_neg,       // [N, K]
    const float* __restrict__ a_gt,          // [N, K]
    const float* __restrict__ a_lt,          // [N, K]
    const int32_t* __restrict__ b_mask,      // [I, K, W]
    const uint8_t* __restrict__ b_def,       // [I, K]
    const uint8_t* __restrict__ b_neg,       // [I, K]
    const float* __restrict__ b_gt,          // [I, K]
    const float* __restrict__ b_lt,          // [I, K]
    const int32_t* __restrict__ vocab_w,     // [W]
    const float* __restrict__ vocab_ints,    // [K, V]
    const uint8_t* __restrict__ key_bounds,  // [K]
    const uint8_t* __restrict__ zone_ok,     // [N, Z]
    const uint8_t* __restrict__ ct_ok,       // [N, CT]
    const uint8_t* __restrict__ avail,       // [I, Z, CT]
    const float* __restrict__ used,          // [N, R]
    const float* __restrict__ size,          // [R]
    const float* __restrict__ alloc,         // [I, R]
    uint8_t* __restrict__ it_ok_out,         // [N, I]
    int32_t* __restrict__ cap_out,           // [N, I]
    int32_t* __restrict__ cap_n_out) {       // [N]
  const int n = blockIdx.x;
  __shared__ int32_t red[kThreads];
  // this tenant's planes (every operand above is per tenant: [B, ...])
  const size_t tb = blockIdx.y;
  const size_t rows_k = (size_t)n_rows * n_keys, types_k = (size_t)n_types * n_keys;
  viable += tb * n_rows * n_types;
  cls_it += tb * n_types;
  a_mask += tb * rows_k * n_words;
  a_def += tb * rows_k;
  a_neg += tb * rows_k;
  a_gt += tb * rows_k;
  a_lt += tb * rows_k;
  b_mask += tb * types_k * n_words;
  b_def += tb * types_k;
  b_neg += tb * types_k;
  b_gt += tb * types_k;
  b_lt += tb * types_k;
  vocab_ints += tb * n_keys * n_vocab;
  zone_ok += tb * n_rows * n_zones;
  ct_ok += tb * n_rows * n_ct;
  avail += tb * n_types * n_zones * n_ct;
  used += tb * n_rows * n_res;
  size += tb * n_res;
  alloc += tb * n_types * n_res;
  it_ok_out += tb * n_rows * n_types;
  cap_out += tb * n_rows * n_types;
  cap_n_out += tb * n_rows;

  float used_r[kMaxR];
  for (int r = 0; r < n_res; ++r) used_r[r] = used[n * n_res + r];

  int32_t best = 0;
  for (int i = threadIdx.x; i < n_types; i += kThreads) {
    bool ok = viable[(size_t)n * n_types + i] && cls_it[i];
    // Requirements.Intersects, key by key (requirements.go:189-206): a key
    // passes when it is not defined on both sides or both sides are
    // negative, else when the intersection is nonempty.  Those two tests
    // come first and skip the word and bound work: on the main path 7 of
    // the 8 bucket-padded keys are defined nowhere.
    for (int k = 0; ok && k < n_keys; ++k) {
      if (!(a_def[n * n_keys + k] && b_def[i * n_keys + k])) continue;
      if (a_neg[n * n_keys + k] && b_neg[i * n_keys + k]) continue;
      const int32_t* am = a_mask + ((size_t)n * n_keys + k) * n_words;
      const int32_t* bm = b_mask + ((size_t)i * n_keys + k) * n_words;
      bool vocab_overlap = false;
      for (int w = 0; w < n_words; ++w) vocab_overlap |= (am[w] & vocab_w[w] & bm[w]) != 0;
      bool unseen = bit_set(am[other_word], other_bitpos) && bit_set(bm[other_word], other_bitpos);
      if (unseen && key_bounds[k]) {
        const float gt = fmaxf(a_gt[n * n_keys + k], b_gt[i * n_keys + k]);
        const float lt = fminf(a_lt[n * n_keys + k], b_lt[i * n_keys + k]);
        const float n_range = fmaxf(ceilf(lt) - floorf(gt) - 1.0f, 0.0f);
        float n_in = 0.0f;
        for (int v = 0; v < n_vocab; ++v) {
          const float x = vocab_ints[k * n_vocab + v];
          n_in += (x > gt && x < lt) ? 1.0f : 0.0f;
        }
        unseen = n_range - n_in >= 1.0f;
      }
      ok = vocab_overlap || unseen;
    }
    // hasOffering over the node's zone x capacity-type rectangle
    if (ok) {
      bool offer = false;
      for (int z = 0; z < n_zones && !offer; ++z) {
        if (!zone_ok[n * n_zones + z]) continue;
        for (int c = 0; c < n_ct; ++c) {
          if (ct_ok[n * n_ct + c] && avail[((size_t)i * n_zones + z) * n_ct + c]) {
            offer = true;
            break;
          }
        }
      }
      ok = offer;
    }
    int32_t cap = 0;
    if (ok) {
      float count = 0.0f;
      for (int r = 0; r < n_res; ++r) {
        const float s = size[r];
        float per = kBig;
        if (s > 0.0f) {
          const float free_r = alloc[i * n_res + r] - used_r[r];
          per = floorf(__fdiv_rn(free_r + 1e-4f, fmaxf(s, 1e-9f)));
        }
        per = fmaxf(per, 0.0f);
        count = (r == 0) ? per : fminf(count, per);
      }
      cap = sat_i32(fminf(count, kBig));
    }
    it_ok_out[(size_t)n * n_types + i] = ok ? 1 : 0;
    cap_out[(size_t)n * n_types + i] = cap;
    best = cap > best ? cap : best;
  }
  red[threadIdx.x] = best;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s && red[threadIdx.x + s] > red[threadIdx.x]) {
      red[threadIdx.x] = red[threadIdx.x + s];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) cap_n_out[n] = red[0];
}

}  // namespace

extern "C" int kc_it_capacity(
    int n_batch, int n_rows, int n_types, int n_keys, int n_words, int n_vocab, int other_word,
    int other_bitpos, int n_res, int n_zones, int n_ct,
    const void* viable, const void* cls_it, const void* a_mask, const void* a_def,
    const void* a_neg, const void* a_gt, const void* a_lt, const void* b_mask,
    const void* b_def, const void* b_neg, const void* b_gt, const void* b_lt,
    const void* vocab_w, const void* vocab_ints, const void* key_bounds,
    const void* zone_ok, const void* ct_ok, const void* avail, const void* used,
    const void* size, const void* alloc, void* it_ok_out, void* cap_out,
    void* cap_n_out, void* stream) {
  if (n_res > kMaxR) return static_cast<int>(cudaErrorInvalidValue);
  if (n_batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0 || n_batch == 0) return 0;
  it_capacity_kernel<<<dim3(n_rows, n_batch), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      n_rows, n_types, n_keys, n_words, n_vocab, other_word, other_bitpos, n_res,
      n_zones, n_ct,
      static_cast<const uint8_t*>(viable), static_cast<const uint8_t*>(cls_it),
      static_cast<const int32_t*>(a_mask), static_cast<const uint8_t*>(a_def),
      static_cast<const uint8_t*>(a_neg), static_cast<const float*>(a_gt),
      static_cast<const float*>(a_lt), static_cast<const int32_t*>(b_mask),
      static_cast<const uint8_t*>(b_def), static_cast<const uint8_t*>(b_neg),
      static_cast<const float*>(b_gt), static_cast<const float*>(b_lt),
      static_cast<const int32_t*>(vocab_w), static_cast<const float*>(vocab_ints),
      static_cast<const uint8_t*>(key_bounds), static_cast<const uint8_t*>(zone_ok),
      static_cast<const uint8_t*>(ct_ok), static_cast<const uint8_t*>(avail),
      static_cast<const float*>(used), static_cast<const float*>(size),
      static_cast<const float*>(alloc), static_cast<uint8_t*>(it_ok_out),
      static_cast<int32_t*>(cap_out), static_cast<int32_t*>(cap_n_out));
  return static_cast<int>(cudaGetLastError());
}
