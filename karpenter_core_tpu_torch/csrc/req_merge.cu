// K3: merge one pod class's requirements into every row of a plane, and
// test each row's compatibility with the class.
//
// Replaces the jnp program of `_merge_node_class` / `_key_compat_node_class`
// (karpenter_core_tpu/ops/solve.py:312-331), which run ops/masks.py `add`
// and `compatible` over a row plane and one class row (the row code is
// req_merge.cuh, shared with K6's commit).  Two entry points:
//
// kc_req_merge  — the merged planes and compat (the slots and templates);
// kc_req_compat — compat alone (the existing rows: K6's commit merges the
//                 rows it selects, so nothing else reads a merged plane).
//
// Tenant axis: the rows are B tenants' planes stacked ([B, N] rows), each
// merged with its own tenant's class row, valid words, vocabulary ints and
// custom-key flags (all [B, ...]).  A solo call is B = 1.
//
// Bound on the H100: bytes.  At the consolidation lanes' 64 x 6,144 rows
// (K = 8 keys, W = 1 word) a row reads 112 bytes and the merge writes 113
// (88.5 MB, 26.4 us at 3.35 TB/s); compat alone writes 1 (44.4 MB, 13.3 us).
// The what-if study's slot plane, 147 x 8,192 rows of one key, moves 34.9
// MB merged (10.4 us).  Design: one thread a row, a 2-D grid with the
// tenant on blockIdx.y, so no block crosses a tenant and nothing divides
// per row.  The thread holds all K keys of its row: the verdict is an AND
// in registers (no shared verdicts, no barrier, no serial pass).  For
// (K, W) = (8, 1) and (1, 1), the shapes the solve paths run, the row's
// planes move as whole vectors into registers (at (8, 1): 32 bytes of
// mask, 8 each of def and neg, 32 each of gt and lt); any other K <= 256
// and W go key by key through the same per-key body (req_merge.cuh).  A
// launch of at least twice as many 128-row tiles as the card has SMs is
// bound by bytes: each block stages its tenant's class row, valid words,
// vocabulary words and ints and custom flags in shared memory once (one
// barrier, before any row), every thread loads 2 rows (4 at (1, 1)) before
// it merges any, and each block takes the same number of its tenant's
// tiles, as few as keep the launch within the blocks the card holds at
// once.  A smaller launch is bound by one thread's chain: a row a thread,
// no staging.  A tenant's operands that do not fit 48 KB of shared memory
// are read from device memory instead.
//
// ptxas (sm_90a, -O3 -Xptxas -v), registers, every kernel a 0-byte stack
// frame and no spill: req_merge_kernel <8, 1, 2 rows> 128, <8, 1, 1> 80,
// <1, 1, 4> 48, <1, 1, 1> 40, <0, 0, 1> 48; req_compat_kernel 96, 56, 48,
// 40, 46.

#include <cuda_runtime.h>
#include <stdint.h>

#include "req_merge.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxKeys = 256;
constexpr int kMaxStage = 48 * 1024;

struct MergeParams {
  kc::MergeShape s;
  int n_rows;  // rows a tenant
  int stage;   // the tenant's operands staged in shared memory
  const int32_t* a_mask;
  const uint8_t* a_def;
  const uint8_t* a_neg;
  const float* a_gt;
  const float* a_lt;
  const int32_t* b_mask;
  const uint8_t* b_def;
  const uint8_t* b_neg;
  const float* b_gt;
  const float* b_lt;
  const int32_t* valid;
  const int32_t* vocab_w;
  const float* vocab_ints;
  const uint8_t* is_custom;
  int32_t* m_mask;
  uint8_t* m_def;
  uint8_t* m_neg;
  float* m_gt;
  float* m_lt;
  uint8_t* compat;
};

// bytes of one tenant's staged operands, every part 4-byte aligned
long long stage_bytes(int k, int w, int v) {
  const long long words = 2LL * k * w + w + 2LL * k + static_cast<long long>(k) * v;
  return 4 * words + 3 * 4 * ((k + 3LL) / 4);
}

template <typename T>
__device__ __forceinline__ const T* stage_copy(const T* src, int n, char*& at) {
  T* dst = reinterpret_cast<T*>(at);
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  at += (static_cast<size_t>(n) * sizeof(T) + 3) & ~static_cast<size_t>(3);
  return dst;
}

// ROWS rows a thread in a tile of ROWS x blockDim.x consecutive rows (the
// warp's rows consecutive for each of them), the block striding over its
// tenant's tiles; a fixed (K, W) loads every row of the tile into
// registers before it merges any, so a thread has ROWS rows' loads in flight
template <int KT, int WT, int ROWS, bool MERGE>
__device__ __forceinline__ void merge_rows(const MergeParams& p) {
  extern __shared__ int4 smem[];
  const kc::MergeShape& s = p.s;
  const int n_keys = KT > 0 ? KT : s.n_keys;
  const int n_words = WT > 0 ? WT : s.n_words;
  const size_t tb = blockIdx.y;
  const size_t kw = static_cast<size_t>(n_keys) * n_words;
  kc::ClassOps c{
      reinterpret_cast<const uint32_t*>(p.b_mask) + tb * kw, p.b_def + tb * n_keys,
      p.b_neg + tb * n_keys, p.b_gt + tb * n_keys, p.b_lt + tb * n_keys,
      reinterpret_cast<const uint32_t*>(p.valid) + tb * kw,
      reinterpret_cast<const uint32_t*>(p.vocab_w),
      p.vocab_ints + tb * n_keys * static_cast<size_t>(s.n_vocab), p.is_custom + tb * n_keys};
  if (p.stage) {
    char* at = reinterpret_cast<char*>(smem);
    c.mask = stage_copy(c.mask, static_cast<int>(kw), at);
    c.valid = stage_copy(c.valid, static_cast<int>(kw), at);
    c.vocab_w = stage_copy(c.vocab_w, n_words, at);
    c.gt = stage_copy(c.gt, n_keys, at);
    c.lt = stage_copy(c.lt, n_keys, at);
    c.vocab_ints = stage_copy(c.vocab_ints, n_keys * s.n_vocab, at);
    c.def = stage_copy(c.def, n_keys, at);
    c.neg = stage_copy(c.neg, n_keys, at);
    c.is_custom = stage_copy(c.is_custom, n_keys, at);
    __syncthreads();
  }
  const int tile = ROWS * blockDim.x;
  for (int first = blockIdx.x * tile; first < p.n_rows; first += gridDim.x * tile) {
    auto in = [&](int row) {
      const size_t r = tb * p.n_rows + row;
      return kc::RowIn{reinterpret_cast<const uint32_t*>(p.a_mask) + r * kw, p.a_def + r * n_keys,
                       p.a_neg + r * n_keys, p.a_gt + r * n_keys, p.a_lt + r * n_keys};
    };
    auto out = [&](int row) {
      const size_t r = tb * p.n_rows + row;
      if (!MERGE) return kc::RowOut{};
      return kc::RowOut{reinterpret_cast<uint32_t*>(p.m_mask) + r * kw, p.m_def + r * n_keys,
                        p.m_neg + r * n_keys, p.m_gt + r * n_keys, p.m_lt + r * n_keys};
    };
    if constexpr (KT > 0) {
      kc::RowRegs<KT, WT> a[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int row = first + i * blockDim.x + threadIdx.x;
        if (row < p.n_rows) kc::load_row(a[i], in(row));
      }
#pragma unroll
      for (int i = 0; i < ROWS; ++i) {
        const int row = first + i * blockDim.x + threadIdx.x;
        if (row < p.n_rows) {
          const bool ok = kc::finish_row<KT, WT, MERGE, true>(s, c, a[i], out(row), true);
          p.compat[tb * p.n_rows + row] = ok ? 1 : 0;
        }
      }
    } else {
      const int row = first + threadIdx.x;
      if (row < p.n_rows) {
        const bool ok = kc::merge_row<0, 0, MERGE, true>(s, c, in(row), out(row), true);
        p.compat[tb * p.n_rows + row] = ok ? 1 : 0;
      }
    }
  }
}

// the two entry points' kernels (apart in a profile)
template <int KT, int WT, int ROWS>
__global__ void __launch_bounds__(kThreads)
    req_merge_kernel(const __grid_constant__ MergeParams p) {
  merge_rows<KT, WT, ROWS, true>(p);
}

template <int KT, int WT, int ROWS>
__global__ void __launch_bounds__(kThreads)
    req_compat_kernel(const __grid_constant__ MergeParams p) {
  merge_rows<KT, WT, ROWS, false>(p);
}

int sm_count() {
  static int sms = 0;  // read once
  if (sms == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
      sms = 132;
    }
  }
  return sms;
}

// Launches the kernel of a fixed (K, W) (KT = 0: any) with ROWS rows a
// thread.  The grid: every block the same number of its tenant's tiles, as
// few tiles a block as keep the launch within the blocks the card holds at
// once (so no second wave runs a tail of blocks).
template <bool MERGE, int KT, int WT, int ROWS>
void launch_fixed(const MergeParams& q, int n_batch, size_t smem, cudaStream_t stream) {
  const auto kernel = MERGE ? req_merge_kernel<KT, WT, ROWS> : req_compat_kernel<KT, WT, ROWS>;
  int resident = 1;  // blocks an SM holds at this shared memory
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel, kThreads, smem) !=
          cudaSuccess || resident < 1) {
    resident = 1;
  }
  const long long tiles = (q.n_rows + ROWS * kThreads - 1) / (ROWS * kThreads);
  const long long fit = (static_cast<long long>(resident) * sm_count() + n_batch - 1) / n_batch;
  const long long per_block = (tiles + fit - 1) / fit;
  const dim3 grid(static_cast<unsigned>((tiles + per_block - 1) / per_block), n_batch);
  kernel<<<grid, kThreads, smem, stream>>>(q);
}

// every pointer on a 16-byte boundary
template <typename... P>
bool aligned16(const P*... ptrs) {
  return ((reinterpret_cast<uintptr_t>(ptrs) % 16 == 0) && ...);
}

template <bool MERGE>
int launch(const MergeParams& p, int n_batch, cudaStream_t stream) {
  const int n_keys = p.s.n_keys, n_words = p.s.n_words;
  if (n_keys < 1 || n_keys > kMaxKeys || n_words < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_batch <= 0 || p.n_rows <= 0) return 0;
  if (n_batch > 65535 || static_cast<long long>(n_batch) * p.n_rows > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  MergeParams q = p;
  const long long bytes = stage_bytes(n_keys, n_words, p.s.n_vocab);
  q.stage = bytes <= kMaxStage;
  // the fixed paths: their planes start on 16-byte boundaries (a row's
  // vectors then stay aligned)
  const bool aligned = aligned16(p.a_mask, p.a_def, p.a_neg, p.a_gt, p.a_lt) &&
                       (!MERGE || aligned16(p.m_mask, p.m_def, p.m_neg, p.m_gt, p.m_lt));
  // a launch of fewer tiles than the card has SMs is bound by one thread's
  // chain: a row a thread and no staging (its barrier is on that chain);
  // a larger one stages the tenant's operands and takes several rows a
  // thread, so each thread has their loads in flight at once
  const bool small = static_cast<long long>(n_batch) * ((p.n_rows + kThreads - 1) / kThreads) <
                     2LL * sm_count();
  q.stage = q.stage && !small;
  const size_t smem = q.stage ? static_cast<size_t>(bytes) : 0;
  if (aligned && n_keys == 8 && n_words == 1) {
    if (small) {
      launch_fixed<MERGE, 8, 1, 1>(q, n_batch, smem, stream);
    } else {
      launch_fixed<MERGE, 8, 1, 2>(q, n_batch, smem, stream);
    }
  } else if (aligned && n_keys == 1 && n_words == 1) {
    if (small) {
      launch_fixed<MERGE, 1, 1, 1>(q, n_batch, smem, stream);
    } else {
      launch_fixed<MERGE, 1, 1, 4>(q, n_batch, smem, stream);
    }
  } else {
    launch_fixed<MERGE, 0, 0, 1>(q, n_batch, smem, stream);
  }
  return static_cast<int>(cudaGetLastError());
}

MergeParams params(int n_rows, int n_keys, int n_words, int n_vocab, int other_word,
                   int other_bitpos, int needs_bounds, const void* a_mask, const void* a_def,
                   const void* a_neg, const void* a_gt, const void* a_lt, const void* b_mask,
                   const void* b_def, const void* b_neg, const void* b_gt, const void* b_lt,
                   const void* valid, const void* vocab_w, const void* vocab_ints,
                   const void* is_custom) {
  MergeParams p{};
  p.s = kc::MergeShape{n_keys, n_words, n_vocab, other_word, other_bitpos, needs_bounds};
  p.n_rows = n_rows;
  p.a_mask = static_cast<const int32_t*>(a_mask);
  p.a_def = static_cast<const uint8_t*>(a_def);
  p.a_neg = static_cast<const uint8_t*>(a_neg);
  p.a_gt = static_cast<const float*>(a_gt);
  p.a_lt = static_cast<const float*>(a_lt);
  p.b_mask = static_cast<const int32_t*>(b_mask);
  p.b_def = static_cast<const uint8_t*>(b_def);
  p.b_neg = static_cast<const uint8_t*>(b_neg);
  p.b_gt = static_cast<const float*>(b_gt);
  p.b_lt = static_cast<const float*>(b_lt);
  p.valid = static_cast<const int32_t*>(valid);
  p.vocab_w = static_cast<const int32_t*>(vocab_w);
  p.vocab_ints = static_cast<const float*>(vocab_ints);
  p.is_custom = static_cast<const uint8_t*>(is_custom);
  return p;
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
  MergeParams p = params(n_rows, n_keys, n_words, n_vocab, other_word, other_bitpos, needs_bounds,
                         a_mask, a_def, a_neg, a_gt, a_lt, b_mask, b_def, b_neg, b_gt, b_lt,
                         valid, vocab_w, vocab_ints, is_custom);
  p.m_mask = static_cast<int32_t*>(m_mask);
  p.m_def = static_cast<uint8_t*>(m_def);
  p.m_neg = static_cast<uint8_t*>(m_neg);
  p.m_gt = static_cast<float*>(m_gt);
  p.m_lt = static_cast<float*>(m_lt);
  p.compat = static_cast<uint8_t*>(compat);
  return launch<true>(p, n_batch, static_cast<cudaStream_t>(stream));
}

extern "C" int kc_req_compat(
    int n_batch, int n_rows, int n_keys, int n_words, int n_vocab, int other_word, int other_bitpos,
    const void* a_mask, const void* a_def, const void* a_neg, const void* a_gt,
    const void* a_lt, const void* b_mask, const void* b_def, const void* b_neg,
    const void* b_gt, const void* b_lt, const void* valid, const void* vocab_w,
    const void* vocab_ints, const void* is_custom, void* compat, void* stream) {
  MergeParams p = params(n_rows, n_keys, n_words, n_vocab, other_word, other_bitpos, 0, a_mask,
                         a_def, a_neg, a_gt, a_lt, b_mask, b_def, b_neg, b_gt, b_lt, valid,
                         vocab_w, vocab_ints, is_custom);
  p.compat = static_cast<uint8_t*>(compat);
  return launch<false>(p, n_batch, static_cast<cudaStream_t>(stream));
}
