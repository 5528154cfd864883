// One row's requirement merge with one class row, and the row's
// compatibility with it: the device code of ops/masks.py `add` (:297,
// through `intersection` :232 and `derive_negative` :185) and `compatible`
// (:279) in karpenter_core_tpu, for a single row.  K3 (req_merge.cu) runs
// it one thread a row; K6's commit (existing_phase.cu) runs its merge half
// on the existing rows it selects.
//
//   merged[k] = row[k] AND class[k]   (words AND, defined OR, gt max, lt min,
//                                      negativity re-derived from the result)
//   compat    = AND_k (!checked | nonempty | both negative)
//               AND NOT any_k (custom key the class requires positively
//                              and the row leaves undefined)
//
// One thread owns all K keys of its row, so the compatibility is an AND in
// registers.  `merge_row<KT, WT, ...>` takes (K, W) as template parameters
// for the shapes the solve paths use (the row's planes are loaded into
// registers first, `load_row`, as whole vectors where K is a multiple of 4,
// then merged and stored, `finish_row`, so a caller can have several rows'
// loads in flight), and `merge_row<0, 0, ...>` takes any K and W at run
// time, key by key through device memory.  Both run the same per-key body,
// `merge_key`.
//
// Exact as the reference: mask words are tested with `&` (never an
// arithmetic `>>`), gt and lt are fmaxf / fminf, the unseen range count is
// the same float sums of 1.0, and the bounds correction of derive_negative
// runs only under `needs_bounds` (some key of the problem carries Gt/Lt).
// The merge is idempotent (AND, OR, max and min are, and negativity is
// derived from the merged words and bounds alone), which is what lets K6
// merge a row at its commit instead of at the class's start.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace kc {

// One tenant's class row and vocabulary planes: in shared memory where the
// kernel staged them, else in device memory.
struct ClassOps {
  const uint32_t* mask;      // [K, W]
  const uint8_t* def;        // [K]
  const uint8_t* neg;        // [K]
  const float* gt;           // [K]
  const float* lt;           // [K]
  const uint32_t* valid;     // [K, W]
  const uint32_t* vocab_w;   // [W] the in-vocabulary slots
  const float* vocab_ints;   // [K, V]
  const uint8_t* is_custom;  // [K] (compatibility only)
};

struct MergeShape {
  int n_keys, n_words, n_vocab;
  int other_word, other_bitpos;  // the trailing "unseen values" slot
  int needs_bounds;
};

// One row's five planes (a row of [.., K, W] words and [.., K] keys).
struct RowIn {
  const uint32_t* mask;
  const uint8_t* def;
  const uint8_t* neg;
  const float* gt;
  const float* lt;
};

struct RowOut {
  uint32_t* mask;
  uint8_t* def;
  uint8_t* neg;
  float* gt;
  float* lt;
};

struct KeyOut {
  bool def, neg;
  float gt, lt;
};

// derive_negative's bounds correction: some excluded vocabulary value lies
// inside (gt, lt).  Walks the set bits of the exclusion words.
template <int WT>
__device__ __forceinline__ bool bounded_exclusions(const MergeShape& s, const ClassOps& c, int k,
                                                   const uint32_t* am, const uint32_t* bm,
                                                   float gt, float lt) {
  const int n_words = WT > 0 ? WT : s.n_words;
  bool bounded = false;
#pragma unroll
  for (int w = 0; w < n_words; ++w) {
    uint32_t x = c.valid[k * n_words + w] & ~(am[w] & bm[w]) & c.vocab_w[w];
    while (x != 0u) {
      const int v = w * 32 + __ffs(x) - 1;
      x &= x - 1u;
      if (v < s.n_vocab) {
        const float val = c.vocab_ints[k * s.n_vocab + v];
        bounded |= val > gt && val < lt;
      }
    }
  }
  return bounded;
}

// the (gt, lt) range admits an integer outside the vocabulary
// (requirement.go:227-243): the same float sums as the reference's count
__device__ __forceinline__ bool unseen_range(const MergeShape& s, const ClassOps& c, int k,
                                             float gt, float lt) {
  const float n_range = fmaxf(ceilf(lt) - floorf(gt) - 1.0f, 0.0f);
  // an unbounded range minus at most V counted values is still infinite:
  // the count cannot change the answer (every key without Gt/Lt)
  if (isinf(n_range)) return true;
  float n_in = 0.0f;
  for (int v = 0; v < s.n_vocab; ++v) {
    const float x = c.vocab_ints[k * s.n_vocab + v];
    n_in += (x > gt && x < lt) ? 1.0f : 0.0f;
  }
  return n_range - n_in >= 1.0f;
}

// Key k of one row: its merge (MERGE: the words into mm, the rest into out)
// and its verdict (COMPAT; true otherwise).  `am` holds the row's W words
// of key k (registers or device memory).
template <int WT, bool MERGE, bool COMPAT>
__device__ __forceinline__ bool merge_key(const MergeShape& s, const ClassOps& c, int k,
                                          const uint32_t* am, bool adef, bool aneg, float agt,
                                          float alt, uint32_t* mm, KeyOut& out) {
  const int n_words = WT > 0 ? WT : s.n_words;
  const uint32_t* bm = c.mask + k * n_words;
  const bool bdef = c.def[k] != 0, bneg = c.neg[k] != 0;
  const float gt = fmaxf(agt, c.gt[k]);
  const float lt = fminf(alt, c.lt[k]);
  bool any_set = false, vocab_overlap = false, excl_any = false;
  uint32_t a_other = 0u, b_other = 0u;
#pragma unroll
  for (int w = 0; w < n_words; ++w) {
    const uint32_t a = am[w], b = bm[w], m = a & b;
    if (MERGE) mm[w] = m;
    any_set |= m != 0u;
    vocab_overlap |= (m & c.vocab_w[w]) != 0u;
    excl_any |= (c.valid[k * n_words + w] & ~m & c.vocab_w[w]) != 0u;
    if (w == s.other_word) {
      a_other = a;
      b_other = b;
    }
  }
  const uint32_t obit = 1u << s.other_bitpos;
  if (MERGE) {
    // derive_negative (requirement.go:139-143, 186-197)
    bool exclusions = excl_any;
    if (s.needs_bounds && (isfinite(gt) || isfinite(lt))) {
      exclusions = bounded_exclusions<WT>(s, c, k, am, bm, gt, lt);
    }
    out.def = adef || bdef;
    out.neg = ((a_other & b_other & obit) != 0u && exclusions) || !any_set;
    out.gt = gt;
    out.lt = lt;
  }
  if (!COMPAT) return true;
  // Compatible (requirements.go:123-133) of the unmerged pair
  const bool checked = adef && bdef;
  bool unseen = (a_other & obit) != 0u && (b_other & obit) != 0u;
  if (unseen) unseen = unseen_range(s, c, k, gt, lt);
  const bool key_ok = !checked || vocab_overlap || unseen || (aneg && bneg);
  const bool denied = c.is_custom[k] != 0 && bdef && !bneg && !adef;
  return key_ok && !denied;
}

// N consecutive 32-bit words between device memory and registers, in the
// widest vectors N allows (the caller keeps the address aligned to them)
template <int N>
__device__ __forceinline__ void load_words(uint32_t (&r)[N], const void* src) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const uint4 v = __ldg(static_cast<const uint4*>(src) + i);
      r[4 * i] = v.x; r[4 * i + 1] = v.y; r[4 * i + 2] = v.z; r[4 * i + 3] = v.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) {
      const uint2 v = __ldg(static_cast<const uint2*>(src) + i);
      r[2 * i] = v.x; r[2 * i + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) r[i] = __ldg(static_cast<const uint32_t*>(src) + i);
  }
}

template <int N>
__device__ __forceinline__ void store_words(void* dst, const uint32_t (&r)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      static_cast<uint4*>(dst)[i] = make_uint4(r[4 * i], r[4 * i + 1], r[4 * i + 2], r[4 * i + 3]);
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int i = 0; i < N / 2; ++i) static_cast<uint2*>(dst)[i] = make_uint2(r[2 * i], r[2 * i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) static_cast<uint32_t*>(dst)[i] = r[i];
  }
}

// K bytes (one a key) between device memory and the words of registers
// that hold them four a word: whole words when K is a multiple of 4, else
// byte by byte
template <int KT>
__device__ __forceinline__ void load_bytes(uint32_t (&r)[(KT + 3) / 4], const uint8_t* src) {
  if constexpr (KT % 4 == 0) {
    load_words<KT / 4>(r, src);
  } else {
#pragma unroll
    for (int i = 0; i < (KT + 3) / 4; ++i) r[i] = 0u;
#pragma unroll
    for (int k = 0; k < KT; ++k) r[k >> 2] |= static_cast<uint32_t>(__ldg(src + k)) << (8 * (k & 3));
  }
}

template <int KT>
__device__ __forceinline__ void store_bytes(uint8_t* dst, const uint32_t (&r)[(KT + 3) / 4]) {
  if constexpr (KT % 4 == 0) {
    store_words<KT / 4>(dst, r);
  } else {
#pragma unroll
    for (int k = 0; k < KT; ++k) dst[k] = static_cast<uint8_t>(r[k >> 2] >> (8 * (k & 3)));
  }
}

__device__ __forceinline__ bool byte_of(const uint32_t* words, int k) {
  return ((words[k >> 2] >> (8 * (k & 3))) & 0xffu) != 0u;
}

// One row of a fixed (K, W) in registers (gt and lt as their bits)
template <int KT, int WT>
struct RowRegs {
  uint32_t mask[KT * WT], def[(KT + 3) / 4], neg[(KT + 3) / 4], gt[KT], lt[KT];
};

// the row's planes into registers, in the widest vectors they allow (the
// caller keeps each plane's start on a 16-byte boundary)
template <int KT, int WT>
__device__ __forceinline__ void load_row(RowRegs<KT, WT>& r, const RowIn& in) {
  load_words<KT * WT>(r.mask, in.mask);
  load_bytes<KT>(r.def, in.def);
  load_bytes<KT>(r.neg, in.neg);
  load_words<KT>(r.gt, in.gt);
  load_words<KT>(r.lt, in.lt);
}

template <int KT, int WT>
__device__ __forceinline__ void store_row(const RowOut& out, const RowRegs<KT, WT>& r) {
  store_words<KT * WT>(out.mask, r.mask);
  store_bytes<KT>(out.def, r.def);
  store_bytes<KT>(out.neg, r.neg);
  store_words<KT>(out.gt, r.gt);
  store_words<KT>(out.lt, r.lt);
}

// A loaded row: merged into `out` where `take` (MERGE; a copy of the row
// where not), and its compatibility (COMPAT; true otherwise).
template <int KT, int WT, bool MERGE, bool COMPAT>
__device__ __forceinline__ bool finish_row(const MergeShape& s, const ClassOps& c,
                                           const RowRegs<KT, WT>& a, const RowOut& out,
                                           bool take) {
  bool ok = true;
  RowRegs<KT, WT> m;
#pragma unroll
  for (int i = 0; i < (KT + 3) / 4; ++i) m.def[i] = m.neg[i] = 0u;
#pragma unroll
  for (int k = 0; k < KT && (COMPAT || take); ++k) {
    KeyOut ko;
    ok &= merge_key<WT, MERGE, COMPAT>(s, c, k, a.mask + k * WT, byte_of(a.def, k),
                                       byte_of(a.neg, k), __uint_as_float(a.gt[k]),
                                       __uint_as_float(a.lt[k]), m.mask + k * WT, ko);
    if (MERGE) {
      m.def[k >> 2] |= (ko.def ? 1u : 0u) << (8 * (k & 3));
      m.neg[k >> 2] |= (ko.neg ? 1u : 0u) << (8 * (k & 3));
      m.gt[k] = __float_as_uint(ko.gt);
      m.lt[k] = __float_as_uint(ko.lt);
    }
  }
  if (MERGE) {
    if (take) {
      store_row(out, m);
    } else {
      store_row(out, a);
    }
  }
  return ok;
}

// One row: merged into `out` where `take` (MERGE; a copy of the row where
// not), and its compatibility (COMPAT; true otherwise).  KT > 0: the
// fixed path, through registers; KT = 0: any K and W, key by key.
template <int KT, int WT, bool MERGE, bool COMPAT>
__device__ __forceinline__ bool merge_row(const MergeShape& s, const ClassOps& c, const RowIn& in,
                                          const RowOut& out, bool take) {
  if constexpr (KT > 0) {
    RowRegs<KT, WT> a;
    load_row(a, in);
    return finish_row<KT, WT, MERGE, COMPAT>(s, c, a, out, take);
  } else {
    bool ok = true;
    const int n_words = s.n_words;
    for (int k = 0; k < s.n_keys; ++k) {
      const uint32_t* am = in.mask + k * n_words;
      uint32_t* mm = out.mask + k * n_words;
      if (MERGE && !take) {
        for (int w = 0; w < n_words; ++w) mm[w] = am[w];
        out.def[k] = in.def[k];
        out.neg[k] = in.neg[k];
        out.gt[k] = in.gt[k];
        out.lt[k] = in.lt[k];
        continue;
      }
      KeyOut ko;
      ok &= merge_key<0, MERGE, COMPAT>(s, c, k, am, in.def[k] != 0, in.neg[k] != 0, in.gt[k],
                                        in.lt[k], mm, ko);
      if (MERGE) {
        out.def[k] = ko.def ? 1 : 0;
        out.neg[k] = ko.neg ? 1 : 0;
        out.gt[k] = ko.gt;
        out.lt[k] = ko.lt;
      }
    }
    return ok;
  }
}

}  // namespace kc
