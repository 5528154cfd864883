// K3: merge one pod class's requirements into every slot, and test each
// slot's compatibility with the class.
//
// Replaces the jnp program of `_merge_node_class` / `_key_compat_node_class`
// (karpenter_core_tpu/ops/solve.py:312-331), which run ops/masks.py `add`
// (:297, through `intersection` :232 and `derive_negative` :185) and
// `compatible` (:279) over a slot plane and one class row:
//
//   merged[n,k]  = node[n,k] AND class[k]      (words AND, defined OR,
//                                               gt max, lt min, negativity
//                                               re-derived from the result)
//   compat[n]    = AND_k (!checked | nonempty | both negative)
//                  AND NOT any_k (custom key the class requires positively
//                                 and the node leaves undefined)
//
// Bound on the H100: latency.  At N=8192 slots and a few keys it moves well
// under 1 MB.  Design: one thread per (slot, key) — a block holds whole
// slots (K * floor(256 / K) threads), so the per-slot AND over keys is a
// shared-memory pass by the slot's key-0 thread, with no second launch.
// Tenant axis: the slot rows may be B tenants' planes stacked ([B, N]
// rows), each merged with its own tenant's class row, valid words,
// vocabulary ints and custom-key flags (all [B, ...]); the flat row index
// gives the tenant.  A solo call is B = 1.
// Mask words are int32 and bits are tested with `&`, never an arithmetic
// `>>`.  The bounds correction of derive_negative runs only when some key
// of the problem carries Gt/Lt bounds (`needs_bounds`), as in the reference.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 256;

__device__ __forceinline__ bool bit_set(int32_t word, int b) {
  return (word & static_cast<int32_t>(1u << b)) != 0;
}

__global__ void req_merge_kernel(
    int n_total, int n_rows, int n_keys, int n_words, int n_vocab, int other_word, int other_bitpos,
    int needs_bounds,
    const int32_t* __restrict__ a_mask, const uint8_t* __restrict__ a_def,
    const uint8_t* __restrict__ a_neg, const float* __restrict__ a_gt,
    const float* __restrict__ a_lt,
    const int32_t* __restrict__ b_mask, const uint8_t* __restrict__ b_def,
    const uint8_t* __restrict__ b_neg, const float* __restrict__ b_gt,
    const float* __restrict__ b_lt,
    const int32_t* __restrict__ valid, const int32_t* __restrict__ vocab_w,
    const float* __restrict__ vocab_ints, const uint8_t* __restrict__ is_custom,
    int32_t* __restrict__ m_mask, uint8_t* __restrict__ m_def, uint8_t* __restrict__ m_neg,
    float* __restrict__ m_gt, float* __restrict__ m_lt, uint8_t* __restrict__ compat) {
  __shared__ uint8_t ok_s[kMaxThreads];
  const int rows_per_block = blockDim.x / n_keys;
  const int local_row = threadIdx.x / n_keys;
  const int k = threadIdx.x % n_keys;
  const int n = blockIdx.x * rows_per_block + local_row;
  const bool live = local_row < rows_per_block && n < n_total;

  bool ok = true;
  if (live) {
    // the row's tenant: its class row and its vocabulary planes
    const int tb = n / n_rows;
    b_mask += (size_t)tb * n_keys * n_words;
    b_def += (size_t)tb * n_keys;
    b_neg += (size_t)tb * n_keys;
    b_gt += (size_t)tb * n_keys;
    b_lt += (size_t)tb * n_keys;
    valid += (size_t)tb * n_keys * n_words;
    vocab_ints += (size_t)tb * n_keys * n_vocab;
    is_custom += (size_t)tb * n_keys;
    const int nk = n * n_keys + k;
    const int32_t* am = a_mask + (size_t)nk * n_words;
    const int32_t* bm = b_mask + (size_t)k * n_words;
    int32_t* mm = m_mask + (size_t)nk * n_words;
    const bool adef = a_def[nk], bdef = b_def[k];
    const bool aneg = a_neg[nk], bneg = b_neg[k];
    const float gt = fmaxf(a_gt[nk], b_gt[k]);
    const float lt = fminf(a_lt[nk], b_lt[k]);

    bool vocab_overlap = false, any_set = false, excl_any = false;
    for (int w = 0; w < n_words; ++w) {
      const int32_t m = am[w] & bm[w];
      mm[w] = m;
      any_set |= m != 0;
      vocab_overlap |= (m & vocab_w[w]) != 0;
      excl_any |= (valid[k * n_words + w] & ~m & vocab_w[w]) != 0;
    }
    const int32_t m_other = mm[other_word];

    // derive_negative (requirement.go:139-143, 186-197)
    bool exclusions = excl_any;
    if (needs_bounds && (isfinite(gt) || isfinite(lt))) {
      bool bounded = false;
      for (int v = 0; v < n_vocab; ++v) {
        const int w = v / 32, b = v % 32;
        const bool excluded = bit_set(valid[k * n_words + w] & ~mm[w] & vocab_w[w], b);
        const float x = vocab_ints[k * n_vocab + v];
        bounded |= excluded && x > gt && x < lt;
      }
      exclusions = bounded;
    }
    m_def[nk] = adef || bdef;
    m_neg[nk] = (bit_set(m_other, other_bitpos) && exclusions) || !any_set;
    m_gt[nk] = gt;
    m_lt[nk] = lt;

    // Compatible (requirements.go:123-133) of the unmerged pair
    const bool checked = adef && bdef;
    bool unseen = bit_set(am[other_word], other_bitpos) && bit_set(bm[other_word], other_bitpos);
    if (unseen) {
      const float n_range = fmaxf(ceilf(lt) - floorf(gt) - 1.0f, 0.0f);
      float n_in = 0.0f;
      for (int v = 0; v < n_vocab; ++v) {
        const float x = vocab_ints[k * n_vocab + v];
        n_in += (x > gt && x < lt) ? 1.0f : 0.0f;
      }
      unseen = n_range - n_in >= 1.0f;
    }
    const bool key_ok = !checked || vocab_overlap || unseen || (aneg && bneg);
    const bool denied = is_custom[k] && bdef && !bneg && !adef;
    ok = key_ok && !denied;
  }
  ok_s[threadIdx.x] = ok ? 1 : 0;
  __syncthreads();
  if (live && k == 0) {
    bool all = true;
    for (int j = 0; j < n_keys; ++j) all = all && ok_s[threadIdx.x + j];
    compat[n] = all ? 1 : 0;
  }
}

}  // namespace

extern "C" int kc_req_merge(
    int n_batch, int n_rows, int n_keys, int n_words, int n_vocab, int other_word, int other_bitpos,
    int needs_bounds,
    const void* a_mask, const void* a_def, const void* a_neg, const void* a_gt,
    const void* a_lt, const void* b_mask, const void* b_def, const void* b_neg,
    const void* b_gt, const void* b_lt, const void* valid, const void* vocab_w,
    const void* vocab_ints, const void* is_custom, void* m_mask, void* m_def,
    void* m_neg, void* m_gt, void* m_lt, void* compat, void* stream) {
  if (n_keys < 1 || n_keys > kMaxThreads) return static_cast<int>(cudaErrorInvalidValue);
  const long long total = static_cast<long long>(n_batch) * n_rows;
  if (total == 0) return 0;
  if (total > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  const int rows_per_block = kMaxThreads / n_keys;
  const int threads = rows_per_block * n_keys;
  const int blocks = static_cast<int>((total + rows_per_block - 1) / rows_per_block);
  req_merge_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int>(total), n_rows, n_keys, n_words, n_vocab, other_word, other_bitpos,
      needs_bounds,
      static_cast<const int32_t*>(a_mask), static_cast<const uint8_t*>(a_def),
      static_cast<const uint8_t*>(a_neg), static_cast<const float*>(a_gt),
      static_cast<const float*>(a_lt), static_cast<const int32_t*>(b_mask),
      static_cast<const uint8_t*>(b_def), static_cast<const uint8_t*>(b_neg),
      static_cast<const float*>(b_gt), static_cast<const float*>(b_lt),
      static_cast<const int32_t*>(valid), static_cast<const int32_t*>(vocab_w),
      static_cast<const float*>(vocab_ints), static_cast<const uint8_t*>(is_custom),
      static_cast<int32_t*>(m_mask), static_cast<uint8_t*>(m_def),
      static_cast<uint8_t*>(m_neg), static_cast<float*>(m_gt), static_cast<float*>(m_lt),
      static_cast<uint8_t*>(compat));
  return static_cast<int>(cudaGetLastError());
}
