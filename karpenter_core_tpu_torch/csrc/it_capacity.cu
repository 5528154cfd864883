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
// Tenant axis: every operand may carry a leading tenant axis B (coalesced
// tenants, a what-if study's replicas, the relax family's classes);
// blockIdx.y is the tenant and every operand is read at that tenant's base
// offset, the catalog included, since tenants of one shape bucket may hold
// different values.  Only the vocabulary word mask and the per-key bounds
// flags are shared.  A solo call is the same kernel at B = 1.
//
// Bound on the H100: bytes.  At N = 8,192 slots x I = 1,000 types a tenant
// reads viable (8 MB) and writes it_ok (8 MB) and cap_ni (33 MB): 49 MB,
// 15 us at 3.35 TB/s; 147 replicas move 7.4 GB, 2.2 ms.  The compute is
// close behind: R IEEE divides an `ok` pair (3.6 G at B = 147 when every
// pair is `ok`, each a multi-instruction sequence with a range check), so
// the design keeps every other per-pair step to a few instructions.
//
// How each byte is read.  A block of 8 warps serves one tenant's
// `rows_per_warp` x 8 rows (one warp a row at a time), over one tile of
// types (blockIdx.z; one tile covers the catalog unless its planes pass
// 96 KB).  The type side is staged once a block into shared memory, each
// plane [words][types] so that neighbouring lanes read neighbouring words:
// the `defined` and `negative` key flags as K-bit words, the available
// offerings as Z*CT-bit words (zeroed for a type the class excludes, which
// folds `cls_it` in), and `alloc` as [R][I].  The row side is read once a
// row, warp-uniform: its key flags and its allowed zone x capacity-type
// cells become words by ballot, `used` sits in registers (unrolled to the
// kernel's compile-time bound of 4, 8 or 16 resources).  A lane takes four
// consecutive types: one 4-byte load of `viable`, one 16-byte shared load
// per plane, one 4-byte store of `it_ok` and one 16-byte store of `cap_ni`
// where the row's address allows it (bytes and ints at a ragged row start
// or at the catalog's end).  A key runs its word and bound work only where
// both sides define it and not both negate it; its mask words and bounds
// are then read through the read-only path.  The row maximum is one
// `__reduce_max_sync`; with several type tiles, an atomicMax over a
// zeroed `cap_n`.  One launch a call.
//
// Build (nvcc -Xptxas -v, sm_90a, CUDA 12.8), `__launch_bounds__(256, 4)`:
// the R <= 4 kernel (every path of the repository's: R = 3) uses 64
// registers with no stack and no spill; the R <= 8 and R <= 16 kernels 64
// registers and 20 and 24 bytes of spill stores.  Shared memory is
// dynamic only: 4 (2 kw + cw + R) bytes a staged type and 32 (2 kw + cw)
// bytes of row words, 24,096 bytes at the headline (I = 1,000, K = 8,
// Z * CT = 6, R = 3), so four blocks (32 warps) fit an SM.  Each lane's
// `used`, counts and `ok` flags stay in registers.
//
// Arithmetic matches the reference bit for bit:
//  - the divide is IEEE round-to-nearest (`__fdiv_rn`; the library is built
//    without --use_fast_math, and no reciprocal stands in for it), or
//    floor() lands one off at exact multiples.  It runs for every resource
//    of every pair whose `ok` holds, and for no other pair (skipping pairs
//    whose count is already 0 cost more in branches than it saved);
//  - float-to-int32 saturates as XLA's convert does: a class whose requests
//    are all zero gets BIG = 1e30, which must become INT_MAX, not INT_MIN;
//  - mask words are int32 and bits are tested with `&`, never `>>`;
//  - infinite Gt/Lt bounds run through ceil(lt) - floor(gt) - 1 as IEEE
//    infinities, giving the same unbounded range count.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 1e30f;
constexpr int kMaxR = 16;                 // resources a row holds in registers
constexpr int kTileBytes = 96 * 1024;     // staged type planes a block at most
constexpr int kMaxRowsPerWarp = 16;
constexpr int kSms = 132;  // the H100's streaming multiprocessors (the grid's sizing only)

struct Dims {
  int n_rows, n_types, n_keys, n_words, n_vocab, other_word, other_bitpos, n_res;
  int n_zones, n_ct;
  int kw, cw;        // words of key flags and of offering cells
  int tile;          // types a block stages (a multiple of 4: each plane's stride)
  int n_tiles, rows_per_warp;
};

__device__ __forceinline__ int sat_i32(float x) {
  // x >= 0 here (clamped above); XLA converts out-of-range floats to the
  // nearest representable int32
  return x >= 2147483648.0f ? 2147483647 : static_cast<int>(x);
}

__device__ __forceinline__ bool bit_set(int32_t word, int b) {
  return (word & static_cast<int32_t>(1u << b)) != 0;
}

// Requirements.Intersects for one key that both sides define and not both
// negate (requirements.go:189-206): the value sets overlap, or both allow
// values outside the vocabulary and, for a key with numeric bounds, some
// integer in the bounded range lies outside the vocabulary.
__device__ __forceinline__ bool key_intersects(
    const Dims& d, int k, const int32_t* __restrict__ am, const int32_t* __restrict__ bm,
    const int32_t* __restrict__ vocab_w, const float* __restrict__ vocab_ints,
    const uint8_t* __restrict__ key_bounds, float a_gt, float a_lt, const float* b_gt,
    const float* b_lt) {
  bool overlap = false;
  for (int w = 0; w < d.n_words; ++w) {
    overlap |= (__ldg(am + w) & __ldg(vocab_w + w) & __ldg(bm + w)) != 0;
  }
  if (overlap) return true;
  bool unseen = bit_set(__ldg(am + d.other_word), d.other_bitpos) &&
                bit_set(__ldg(bm + d.other_word), d.other_bitpos);
  if (unseen && __ldg(key_bounds + k)) {
    const float gt = fmaxf(a_gt, __ldg(b_gt));
    const float lt = fminf(a_lt, __ldg(b_lt));
    const float n_range = fmaxf(ceilf(lt) - floorf(gt) - 1.0f, 0.0f);
    float n_in = 0.0f;
    for (int v = 0; v < d.n_vocab; ++v) {
      const float x = __ldg(vocab_ints + k * d.n_vocab + v);
      n_in += (x > gt && x < lt) ? 1.0f : 0.0f;
    }
    unseen = n_range - n_in >= 1.0f;
  }
  return unseen;
}

// The viable bytes of types [s, s + 4) of a row (past n_t: 0), one byte
// each of the word: one 4-byte load where the address allows it.
__device__ __forceinline__ uint32_t viable_word(const uint8_t* vrow, int s, int n_t, bool al) {
  if (s + 4 <= n_t && al) return __ldg(reinterpret_cast<const unsigned int*>(vrow + s));
  uint32_t vb = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (s + e < n_t && vrow[s + e]) vb |= 1u << (8 * e);
  }
  return vb;
}

template <int R>
__global__ void __launch_bounds__(kThreads, 4) it_capacity_kernel(
    const Dims d,
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
  extern __shared__ __align__(16) uint32_t smem[];
  const int n_rows = d.n_rows, n_types = d.n_types, n_keys = d.n_keys;
  const int n_res = d.n_res, n_cells = d.n_zones * d.n_ct;
  // this tenant's planes (every operand above is per tenant: [B, ...])
  const size_t tb = blockIdx.y;
  const size_t rows_k = (size_t)n_rows * n_keys, types_k = (size_t)n_types * n_keys;
  viable += tb * n_rows * n_types;
  cls_it += tb * n_types;
  a_mask += tb * rows_k * d.n_words;
  a_def += tb * rows_k;
  a_neg += tb * rows_k;
  a_gt += tb * rows_k;
  a_lt += tb * rows_k;
  b_mask += tb * types_k * d.n_words;
  b_def += tb * types_k;
  b_neg += tb * types_k;
  b_gt += tb * types_k;
  b_lt += tb * types_k;
  vocab_ints += tb * n_keys * d.n_vocab;
  zone_ok += tb * n_rows * d.n_zones;
  ct_ok += tb * n_rows * d.n_ct;
  avail += tb * n_types * n_cells;
  used += tb * n_rows * n_res;
  size += tb * n_res;
  alloc += tb * n_types * n_res;
  it_ok_out += tb * n_rows * n_types;
  cap_out += tb * n_rows * n_types;
  cap_n_out += tb * n_rows;

  // -- the tile's type planes, staged once ------------------------------------
  const int stride = d.tile, kw = d.kw, cw = d.cw;
  uint32_t* s_def = smem;                           // [kw][stride]
  uint32_t* s_neg = s_def + kw * stride;            // [kw][stride]
  uint32_t* s_offer = s_neg + kw * stride;          // [cw][stride]
  float* s_alloc = reinterpret_cast<float*>(s_offer + cw * stride);  // [R][stride]
  uint32_t* s_rows = s_offer + (cw + n_res) * stride;  // [kWarps][2 kw + cw]
  const int t0 = blockIdx.z * d.tile;
  const int n_t = min(n_types - t0, d.tile);
  for (int s = threadIdx.x; s < stride; s += kThreads) {
    const int t = t0 + s;
    const bool in = s < n_t;
    for (int w = 0; w < kw; ++w) {
      uint32_t dw = 0, nw = 0;
      if (in) {
        const int k_end = min(n_keys, 32 * w + 32);
        for (int k = 32 * w; k < k_end; ++k) {
          if (b_def[(size_t)t * n_keys + k]) dw |= 1u << (k & 31);
          if (b_neg[(size_t)t * n_keys + k]) nw |= 1u << (k & 31);
        }
      }
      s_def[w * stride + s] = dw;
      s_neg[w * stride + s] = nw;
    }
    const bool sel = in && cls_it[t];
    for (int w = 0; w < cw; ++w) {
      uint32_t ow = 0;
      if (sel) {
        const int j_end = min(n_cells, 32 * w + 32);
        for (int j = 32 * w; j < j_end; ++j) {
          if (avail[(size_t)t * n_cells + j]) ow |= 1u << (j & 31);
        }
      }
      s_offer[w * stride + s] = ow;
    }
    for (int r = 0; r < n_res; ++r) {
      s_alloc[r * stride + s] = in ? alloc[(size_t)t * n_res + r] : 0.0f;
    }
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t* row_def = s_rows + warp * (2 * kw + cw);
  uint32_t* row_neg = row_def + kw;
  uint32_t* row_cells = row_neg + kw;
  const int n_groups = (n_t + 3) >> 2;
  const int row0 = blockIdx.x * kWarps * d.rows_per_warp;

  for (int j = 0; j < d.rows_per_warp; ++j) {
    const int n = row0 + j * kWarps + warp;
    if (n >= n_rows) break;
    const size_t row_base = (size_t)n * n_types + t0;
    const uint8_t* vrow = viable + row_base;
    const bool v_al = (reinterpret_cast<uintptr_t>(vrow) & 3) == 0;
    // the lane's first viable word, in flight while the row side is read
    uint32_t vb_next = lane < n_groups ? viable_word(vrow, 4 * lane, n_t, v_al) : 0u;
    // -- the row side, warp-uniform ------------------------------------------
    for (int w = 0; w < kw; ++w) {
      const int k = 32 * w + lane;
      const bool dd = k < n_keys && a_def[(size_t)n * n_keys + k];
      const bool nn = k < n_keys && a_neg[(size_t)n * n_keys + k];
      const uint32_t dw = __ballot_sync(kFull, dd), nw = __ballot_sync(kFull, nn);
      if (lane == 0) {
        row_def[w] = dw;
        row_neg[w] = nw;
      }
    }
    for (int w = 0; w < cw; ++w) {
      const int c = 32 * w + lane;
      bool on = false;
      if (c < n_cells) {
        const int z = c / d.n_ct;
        on = zone_ok[(size_t)n * d.n_zones + z] && ct_ok[(size_t)n * d.n_ct + (c - z * d.n_ct)];
      }
      const uint32_t cells = __ballot_sync(kFull, on);
      if (lane == 0) row_cells[w] = cells;
    }
    float used_r[R];
    {
      const float u = lane < n_res ? used[(size_t)n * n_res + lane] : 0.0f;
#pragma unroll
      for (int r = 0; r < R; ++r) used_r[r] = __shfl_sync(kFull, u, r);
    }
    __syncwarp();

    uint8_t* okrow = it_ok_out + row_base;
    int32_t* caprow = cap_out + row_base;
    const bool o_al = (reinterpret_cast<uintptr_t>(okrow) & 3) == 0 &&
                      (reinterpret_cast<uintptr_t>(caprow) & 15) == 0;
    const int32_t* am_row = a_mask + (size_t)n * n_keys * d.n_words;
    int32_t best = 0;

    for (int g = lane; g < n_groups; g += 32) {
      const int s = 4 * g;  // the group's first type, in the tile
      const bool full = s + 4 <= n_t;
      const uint32_t vb = vb_next;  // the next group's word goes in flight now
      vb_next = g + 32 < n_groups ? viable_word(vrow, s + 128, n_t, v_al) : 0u;
      bool ok[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) ok[e] = ((vb >> (8 * e)) & 0xffu) != 0;
      int32_t cap[4] = {0, 0, 0, 0};
      if (vb != 0) {
        // hasOffering over the row's zone x capacity-type cells
        uint32_t hit[4] = {0, 0, 0, 0};
        for (int w = 0; w < cw; ++w) {
          const uint4 o = *reinterpret_cast<const uint4*>(s_offer + w * stride + s);
          const uint32_t m = row_cells[w];
          hit[0] |= o.x & m;
          hit[1] |= o.y & m;
          hit[2] |= o.z & m;
          hit[3] |= o.w & m;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) ok[e] = ok[e] && hit[e] != 0;
        // the keys both sides define and not both negate
        for (int w = 0; w < kw; ++w) {
          const uint4 dv = *reinterpret_cast<const uint4*>(s_def + w * stride + s);
          const uint4 nv = *reinterpret_cast<const uint4*>(s_neg + w * stride + s);
          const uint32_t ad = row_def[w], an = row_neg[w];
          const uint32_t dd[4] = {dv.x, dv.y, dv.z, dv.w};
          const uint32_t ng[4] = {nv.x, nv.y, nv.z, nv.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            uint32_t chk = ok[e] ? (ad & dd[e] & ~(an & ng[e])) : 0u;
            while (chk != 0) {
              const int k = 32 * w + __ffs(chk) - 1;
              chk &= chk - 1;
              const size_t ti = (size_t)(t0 + s + e) * n_keys + k;
              const size_t ri = (size_t)n * n_keys + k;
              if (!key_intersects(d, k, am_row + (size_t)k * d.n_words,
                                  b_mask + ti * d.n_words, vocab_w, vocab_ints, key_bounds,
                                  __ldg(a_gt + ri), __ldg(a_lt + ri), b_gt + ti, b_lt + ti)) {
                ok[e] = false;
                break;
              }
            }
          }
        }
        // capacity: min over resources of floor((alloc - used + 1e-4) / size)
        float count[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (r < n_res) {
            const float4 a = *reinterpret_cast<const float4*>(s_alloc + r * stride + s);
            const float av[4] = {a.x, a.y, a.z, a.w};
            const float sz = __ldg(size + r);  // the tenant's request, uniform
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (ok[e]) {
                float per = kBig;
                if (sz > 0.0f) {
                  per = floorf(__fdiv_rn((av[e] - used_r[r]) + 1e-4f, fmaxf(sz, 1e-9f)));
                }
                per = fmaxf(per, 0.0f);
                count[e] = (r == 0) ? per : fminf(count[e], per);
              }
            }
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (ok[e]) {
            cap[e] = sat_i32(fminf(count[e], kBig));
            best = max(best, cap[e]);
          }
        }
      }
      const uint32_t okb = (ok[0] ? 1u : 0u) | (ok[1] ? 1u << 8 : 0u) |
                           (ok[2] ? 1u << 16 : 0u) | (ok[3] ? 1u << 24 : 0u);
      if (full && o_al) {
        *reinterpret_cast<uint32_t*>(okrow + s) = okb;
        *reinterpret_cast<int4*>(caprow + s) = make_int4(cap[0], cap[1], cap[2], cap[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (s + e < n_t) {
            okrow[s + e] = ok[e] ? 1 : 0;
            caprow[s + e] = cap[e];
          }
        }
      }
    }
    best = __reduce_max_sync(kFull, best);
    if (lane == 0) {
      if (d.n_tiles == 1) {
        cap_n_out[n] = best;
      } else {
        atomicMax(cap_n_out + n, best);
      }
    }
    __syncwarp();  // the row words are rewritten by the warp's next row
  }
}

template <int R>
int launch(const Dims& d, int n_batch, size_t smem, cudaStream_t stream, const void* const* p,
           void* it_ok_out, void* cap_out, void* cap_n_out) {
  auto kernel = it_capacity_kernel<R>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int rows_block = kWarps * d.rows_per_warp;
  const dim3 grid((d.n_rows + rows_block - 1) / rows_block, n_batch, d.n_tiles);
  kernel<<<grid, kThreads, smem, stream>>>(
      d, static_cast<const uint8_t*>(p[0]), static_cast<const uint8_t*>(p[1]),
      static_cast<const int32_t*>(p[2]), static_cast<const uint8_t*>(p[3]),
      static_cast<const uint8_t*>(p[4]), static_cast<const float*>(p[5]),
      static_cast<const float*>(p[6]), static_cast<const int32_t*>(p[7]),
      static_cast<const uint8_t*>(p[8]), static_cast<const uint8_t*>(p[9]),
      static_cast<const float*>(p[10]), static_cast<const float*>(p[11]),
      static_cast<const int32_t*>(p[12]), static_cast<const float*>(p[13]),
      static_cast<const uint8_t*>(p[14]), static_cast<const uint8_t*>(p[15]),
      static_cast<const uint8_t*>(p[16]), static_cast<const uint8_t*>(p[17]),
      static_cast<const float*>(p[18]), static_cast<const float*>(p[19]),
      static_cast<const float*>(p[20]), static_cast<uint8_t*>(it_ok_out),
      static_cast<int32_t*>(cap_out), static_cast<int32_t*>(cap_n_out));
  return static_cast<int>(cudaGetLastError());
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
  if (n_res > kMaxR || n_res < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n_batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0 || n_batch == 0) return 0;
  Dims d;
  d.n_rows = n_rows;
  d.n_types = n_types;
  d.n_keys = n_keys;
  d.n_words = n_words;
  d.n_vocab = n_vocab;
  d.other_word = other_word;
  d.other_bitpos = other_bitpos;
  d.n_res = n_res;
  d.n_zones = n_zones;
  d.n_ct = n_ct;
  d.kw = (n_keys + 31) / 32;
  d.cw = (n_zones * n_ct + 31) / 32;
  const int type_bytes = 4 * (2 * d.kw + d.cw + n_res);
  const int fit = std::max(4, (kTileBytes / std::max(type_bytes, 1)) & ~3);
  const int types4 = std::max(4, (n_types + 3) & ~3);
  d.tile = std::min(types4, fit);
  d.n_tiles = std::max(1, (n_types + d.tile - 1) / d.tile);
  if (d.n_tiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  // rows a warp: enough blocks for eight an SM at one row a warp, two to
  // sixteen rows (a block stages its tile once for all of them)
  const long long rows = (long long)n_rows * n_batch * d.n_tiles;
  const long long rows_at_one = (long long)kWarps * kSms * 8;
  const long long per = (rows + rows_at_one - 1) / rows_at_one;
  d.rows_per_warp = static_cast<int>(std::min<long long>(kMaxRowsPerWarp, std::max(2LL, per)));
  const size_t smem = (size_t)type_bytes * d.tile + (size_t)kWarps * (2 * d.kw + d.cw) * 4;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d.n_tiles > 1) {
    // the row maxima gather over tiles by atomicMax; every cap is >= 0
    const cudaError_t e = cudaMemsetAsync(cap_n_out, 0, (size_t)n_batch * n_rows * 4, s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const void* p[21] = {viable, cls_it, a_mask, a_def, a_neg, a_gt, a_lt, b_mask, b_def,
                       b_neg, b_gt, b_lt, vocab_w, vocab_ints, key_bounds, zone_ok, ct_ok,
                       avail, used, size, alloc};
  if (n_res <= 4) return launch<4>(d, n_batch, smem, s, p, it_ok_out, cap_out, cap_n_out);
  if (n_res <= 8) return launch<8>(d, n_batch, smem, s, p, it_ok_out, cap_out, cap_n_out);
  return launch<16>(d, n_batch, smem, s, p, it_ok_out, cap_out, cap_n_out);
}
