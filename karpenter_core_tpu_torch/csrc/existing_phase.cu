// K6: one placement phase on the existing nodes.
//
// Replaces `_phase_existing` (karpenter_core_tpu/ops/solve.py:624) with its
// priority fill (`_fill_by_priority` :419) taken in.  Three entry points:
//
// kc_existing_mask_fill — the whole fill of a phase without hole preferences:
//   zone_ok[e,z] = zone[e,z] & cls_zone[z] & restrict[z]   (the LIVE zone mask)
//   cap[e]       = any_z zone_ok[e,z] ? prep_cap[e] : 0, then 0 where the
//                  extra eligibility (affinity targets, inverse
//                  anti-affinity, rows a zone-committal sweep already used)
//                  is false, then, for a single-node phase, 0 on every row
//                  but the first with cap > 0 (row 0 when there is none)
//   assigned     = the priority fill of `quota` over cap with priority
//                  cap > 0 ? e : INT32_MAX (scheduler.go:176-180 tries
//                  existing nodes first, in order), and placed = sum(assigned)
// kc_existing_mask — the caps, priorities and zone mask alone, for the
//   phases with hole preferences (`_fill_with_pref`, K2 twice).
// kc_existing_commit — the existing-node state after `assigned` pods of the
//   class land (`_phase_existing`'s tail and the committal block's commit):
//   used += assigned * req                   (every row, as the reference)
//   rows with assigned > 0: requirement planes <- the row merged with the
//   class row (req_merge.cuh, K3's row code), zone <- zone_new,
//   ct <- ct_ok, ports |= cls_ports (host ports on),
//   vol_used += vol_add + assigned * per_pod (volume limits on)
//   pod_count += assigned
//
// Tenant axis: the rows may be B tenants' nodes stacked ([B, E]), each
// with its own class vectors ([B, ...]) and quota ([B]).  A solo call is B = 1.
//
// The fill, exactly.  The priorities K2 would sort put the rows with cap > 0
// first, in index order, then the rows with cap <= 0, in index order (their
// priority is INT32_MAX, and the sort is stable).  So a row with cap > 0
// takes clip(quota - before, 0, cap), `before` the exclusive sum of the
// positive caps of the rows before it; a row with cap <= 0 takes
// min(max(x, 0), cap) = cap whatever its `before` (0, or a negative cap,
// which K5 never makes but the twin accepts).  Sums run on uint32, so the
// reference's int32 cumsum and jnp.sum wrap as they do there.
//
// kc_existing_mask_fill: one block of 512 threads a tenant (grid = B), or
// one warp a tenant when the rows fit a warp's tile (up to 384: the cold
// path's dummy row).  The rows go in tiles of 12 consecutive rows a thread
// (6,144 a block): the caps with 16-byte loads, the zone bytes and extra
// flags as 4-byte words when Z <= 4 (a thread's 12 Z zone bytes are 3 Z
// aligned words; zone_ok is written the same way), the class's zone mask
// staged once in shared memory.  Each tile: one block-wide exclusive sum of
// the positive caps (plus the tiles before), the clipped fill written with
// 16-byte stores and summed.  A single-node phase first finds the pinned
// row (each thread's first positive row, one shared atomicMin), then writes
// 0 everywhere but there.  Bound: latency; at E = 6,144 it reads 43 KB and
// writes 43 KB a tenant (0.03 us at 3.35 TB/s).  The fill, its sum and the
// mask are one launch where they were three (mask, K2, a torch sum).
//
// kc_existing_commit: bound by bytes.  At the lanes' B = 64 x E = 6,144 it
// reads and writes every state plane (about 0.29 KB a row) and reads the
// tenant's class row and vocabulary (a few hundred bytes).  The merge of a
// selected row happens here, not in K3 at the class's start: the merge is
// idempotent and within one class step a row changes only through this
// class's commits, so merging the row as it stands gives what merging it
// at the class's start gives, and K3 need not write merged planes for
// every row.  The planes are walked flat as one index space, a grid-stride
// loop over it with the grid sized to the card: the requirement planes a
// whole row a unit (merged or copied; the (8, 1) rows as vectors in
// registers, req_merge.cuh), each other select plane (zone, ct, and ports
// / vol_used when their feature is off) in the widest vector of 16, 8, 4,
// 2 or 1 bytes that divides its row and its pointers' alignment, so a warp
// reads and writes whole contiguous segments; a vector's row is its index
// / the row's vectors, and the row's `assigned` (an L1 hit) picks the new
// or the old plane, so only one of them is read.  `used`, `pod_count`,
// `ports` and `vol_used` (features on) go element by element, also
// coalesced.  Out of place: every output plane is written and no input is
// changed (the reference's `_phase_existing` is functional; callers keep
// the old state).
//
// Arithmetic matches the reference bit for bit: `used + assigned * req` is
// one fused multiply-add rounded once (`__fmaf_rn(a, req, used)`), as XLA's
// CPU code contracts it in the reference's jitted solve (read on non-binary
// requests: every resource column at R >= 4; at R = 3 the third column, the
// pod count, rounds twice there, and its request is always 1, so both
// roundings agree); int32 sums wrap as the reference's do (unsigned
// arithmetic).
// ptxas (sm_90a, -O3 -Xptxas -v): existing_mask_fill_kernel<512, Z> 53-64
// registers, no spill, 2,224 bytes of static shared memory (its scan) and Z
// dynamic; the one-warp <32, Z> 64-71 registers, up to 24 bytes of spill;
// existing_commit_kernel 95 registers, no spill (its plane table stays in
// the constant bank, __grid_constant__); existing_mask_kernel 26.

#include <cub/block/block_reduce.cuh>
#include <cub/block/block_scan.cuh>
#include <cuda_runtime.h>
#include <stdint.h>

#include "req_merge.cuh"

namespace {

constexpr int kMaskThreads = 1024;
constexpr int kFillThreads = 512;  // a block of the fused fill; one warp up to kFillRows * 32 rows
constexpr int kFillRows = 12;  // consecutive rows a thread: a tile of 512 threads is 6,144 rows
constexpr int kCommitThreads = 256;
constexpr int32_t kI32Max = 2147483647;

__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wmul(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) * static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t clip_fill(uint32_t quota, uint32_t before, int32_t cap) {
  int32_t a = static_cast<int32_t>(quota - before);  // int32 wraparound, as the reference
  a = a < 0 ? 0 : a;
  return a > cap ? cap : a;
}

// whether a row takes the class at all: some zone of its live zone mask
// in the class's (writing the row's zone_ok when `zone_ok_out` is given),
// and its extra eligibility
__device__ __forceinline__ bool row_zone_ok(int e, int n_zones, const uint8_t* __restrict__ zone,
                                            const uint8_t* __restrict__ zmask,
                                            const uint8_t* __restrict__ extra,
                                            uint8_t* __restrict__ zone_ok_out) {
  bool any_zone = false;
  for (int z = 0; z < n_zones; ++z) {
    const bool v = zone[e * n_zones + z] && zmask[z];
    if (zone_ok_out != nullptr) zone_ok_out[e * n_zones + z] = v ? 1 : 0;
    any_zone |= v;
  }
  return any_zone && (extra == nullptr || extra[e]);
}

// one row's cap after the live zone mask and the extra eligibility
__device__ __forceinline__ int32_t row_cap(int e, int n_zones, const int32_t* __restrict__ prep_cap,
                                           const uint8_t* __restrict__ zone,
                                           const uint8_t* __restrict__ zmask,
                                           const uint8_t* __restrict__ extra,
                                           uint8_t* __restrict__ zone_ok_out) {
  return row_zone_ok(e, n_zones, zone, zmask, extra, zone_ok_out) ? prep_cap[e] : 0;
}

template <int T>
union FillStorage {
  typename cub::BlockScan<uint32_t, T>::TempStorage scan;
  typename cub::BlockReduce<uint32_t, T>::TempStorage reduce;
};

// kFillRows consecutive rows of Z zones (Z = 1..4): their zone bytes are
// 3 Z whole words, 4-byte aligned.  Loads them at once, writes zone_ok (the
// bytes AND the class's zone mask, `zbits` a bit a zone) and returns whether
// each row keeps some zone.  Bool planes hold 0 or 1 a byte.
template <int Z>
__device__ __forceinline__ void zone_rows(const uint8_t* __restrict__ zone,
                                          uint8_t* __restrict__ zone_ok_out, uint32_t zbits,
                                          bool (&any)[kFillRows]) {
  constexpr int kWords = kFillRows * Z / 4;
  uint32_t w[kWords];
#pragma unroll
  for (int m = 0; m < kWords; ++m) w[m] = reinterpret_cast<const uint32_t*>(zone)[m];
#pragma unroll
  for (int m = 0; m < kWords; ++m) {
    uint32_t keep = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) keep |= ((zbits >> ((4 * m + b) % Z)) & 1u) << (8 * b);
    w[m] &= keep;
    reinterpret_cast<uint32_t*>(zone_ok_out)[m] = w[m];
  }
#pragma unroll
  for (int j = 0; j < kFillRows; ++j) {
    bool some = false;
#pragma unroll
    for (int z = 0; z < Z; ++z) {
      const int k = j * Z + z;
      some |= ((w[k / 4] >> (8 * (k % 4))) & 0xffu) != 0;
    }
    any[j] = some;
  }
}

// T threads a block; Z the zone count when 1..4 (word loads), else 0 (n_zones)
template <int T, int Z>
__global__ void __launch_bounds__(T) existing_mask_fill_kernel(
    int n_rows, int n_zones, int has_extra, int single_node, int vec,
    const int32_t* __restrict__ prep_cap,   // [E]
    const uint8_t* __restrict__ zone,       // [E, Z]
    const uint8_t* __restrict__ cls_zone,   // [Z]
    const uint8_t* __restrict__ restrict_,  // [Z]
    const uint8_t* __restrict__ extra,      // [E] (has_extra)
    const int32_t* __restrict__ quota_p,    // [B]
    int32_t* __restrict__ assigned_out,     // [E]
    int32_t* __restrict__ placed_out,       // [B]
    uint8_t* __restrict__ zone_ok_out) {    // [E, Z]
  using Scan = cub::BlockScan<uint32_t, T>;
  using Reduce = cub::BlockReduce<uint32_t, T>;
  constexpr int kTile = T * kFillRows;
  __shared__ FillStorage<T> storage;
  __shared__ int first;
  extern __shared__ uint8_t zmask[];  // [Z]: cls_zone & restrict
  // this block's tenant
  const size_t tb = blockIdx.x;
  prep_cap += tb * n_rows;
  zone += tb * n_rows * n_zones;
  cls_zone += tb * n_zones;
  restrict_ += tb * n_zones;
  extra = has_extra ? extra + tb * n_rows : nullptr;
  assigned_out += tb * n_rows;
  zone_ok_out += tb * n_rows * n_zones;
  const uint32_t quota = static_cast<uint32_t>(quota_p[tb]);
  for (int z = threadIdx.x; z < n_zones; z += blockDim.x) zmask[z] = cls_zone[z] && restrict_[z];
  if (threadIdx.x == 0) first = kI32Max;
  __syncthreads();
  uint32_t zbits = 0;  // Z > 0: the class's zone mask, a bit a zone
#pragma unroll
  for (int z = 0; z < Z; ++z) zbits |= zmask[z] ? 1u << z : 0u;

  uint32_t placed = 0;
  if (single_node) {
    // the pin: the first row with cap > 0 (jnp.argmax of an all-False mask is 0)
    int mine = kI32Max;
    for (int e = threadIdx.x; e < n_rows; e += blockDim.x) {
      const int32_t cap = row_cap(e, n_zones, prep_cap, zone, zmask, extra, zone_ok_out);
      if (cap > 0 && e < mine) mine = e;
    }
    if (mine != kI32Max) atomicMin(&first, mine);
    __syncthreads();
    const int pin = first == kI32Max ? 0 : first;
    for (int e = threadIdx.x; e < n_rows; e += blockDim.x) {
      if (e != pin) assigned_out[e] = 0;
    }
    if (threadIdx.x == 0) {
      const int32_t cap = row_cap(pin, n_zones, prep_cap, zone, zmask, extra, nullptr);
      const int32_t a = cap > 0 ? clip_fill(quota, 0u, cap) : cap;
      assigned_out[pin] = a;
      placed = static_cast<uint32_t>(a);
    }
  } else {
    uint32_t carry = 0;  // the positive caps of the tiles before
    for (int tile = 0; tile < n_rows; tile += kTile) {
      const int base = tile + threadIdx.x * kFillRows;
      const bool whole = vec && base + kFillRows <= n_rows;  // 16-byte loads and stores
      int32_t cap[kFillRows];
      if (whole) {
#pragma unroll
        for (int j = 0; j < kFillRows; j += 4) {
          const int4 q = *reinterpret_cast<const int4*>(prep_cap + base + j);
          cap[j] = q.x;
          cap[j + 1] = q.y;
          cap[j + 2] = q.z;
          cap[j + 3] = q.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < kFillRows; ++j) cap[j] = base + j < n_rows ? prep_cap[base + j] : 0;
      }
      bool fast = false;
      if constexpr (Z > 0) {
        if (whole) {  // the rows' zone bytes and extra flags as words
          bool any[kFillRows];
          zone_rows<Z>(zone + static_cast<size_t>(base) * Z, zone_ok_out +
                       static_cast<size_t>(base) * Z, zbits, any);
          uint32_t ex[kFillRows / 4];
#pragma unroll
          for (int m = 0; m < kFillRows / 4; ++m) {
            ex[m] = extra == nullptr ? 0x01010101u
                                     : reinterpret_cast<const uint32_t*>(extra + base)[m];
          }
#pragma unroll
          for (int j = 0; j < kFillRows; ++j) {
            if (!any[j] || ((ex[j / 4] >> (8 * (j % 4))) & 0xffu) == 0) cap[j] = 0;
          }
          fast = true;
        }
      }
      if (!fast) {
#pragma unroll
        for (int j = 0; j < kFillRows; ++j) {
          const int e = base + j;
          if (e < n_rows && !row_zone_ok(e, n_zones, zone, zmask, extra, zone_ok_out)) cap[j] = 0;
        }
      }
      uint32_t sum = 0;
#pragma unroll
      for (int j = 0; j < kFillRows; ++j) sum += cap[j] > 0 ? static_cast<uint32_t>(cap[j]) : 0u;
      uint32_t before, tile_sum;
      Scan(storage.scan).ExclusiveSum(sum, before, tile_sum);
      before += carry;
      int32_t a[kFillRows];
#pragma unroll
      for (int j = 0; j < kFillRows; ++j) {
        a[j] = cap[j] > 0 ? clip_fill(quota, before, cap[j]) : cap[j];
        before += cap[j] > 0 ? static_cast<uint32_t>(cap[j]) : 0u;
        if (base + j < n_rows) placed += static_cast<uint32_t>(a[j]);
      }
      if (whole) {
#pragma unroll
        for (int j = 0; j < kFillRows; j += 4) {
          *reinterpret_cast<int4*>(assigned_out + base + j) =
              make_int4(a[j], a[j + 1], a[j + 2], a[j + 3]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < kFillRows; ++j) {
          if (base + j < n_rows) assigned_out[base + j] = a[j];
        }
      }
      carry += tile_sum;
      __syncthreads();  // the next tile's scan reuses the storage
    }
  }
  const uint32_t total = Reduce(storage.reduce).Sum(placed);
  if (threadIdx.x == 0) placed_out[tb] = static_cast<int32_t>(total);
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
  __shared__ int first;
  extern __shared__ uint8_t zmask[];  // [Z]: cls_zone & restrict
  // this block's tenant
  const size_t tb = blockIdx.x;
  prep_cap += tb * n_rows;
  zone += tb * n_rows * n_zones;
  cls_zone += tb * n_zones;
  restrict_ += tb * n_zones;
  extra = has_extra ? extra + tb * n_rows : nullptr;
  cap_out += tb * n_rows;
  priority_out += tb * n_rows;
  zone_ok_out += tb * n_rows * n_zones;
  for (int z = threadIdx.x; z < n_zones; z += blockDim.x) zmask[z] = cls_zone[z] && restrict_[z];
  if (threadIdx.x == 0) first = kI32Max;
  __syncthreads();
  int mine = kI32Max;
  for (int e = threadIdx.x; e < n_rows; e += blockDim.x) {
    const int32_t cap = row_cap(e, n_zones, prep_cap, zone, zmask, extra, zone_ok_out);
    cap_out[e] = cap;
    if (single_node && cap > 0 && e < mine) mine = e;
  }
  if (mine != kI32Max) atomicMin(&first, mine);
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

// -- the commit ------------------------------------------------------------------

enum PlaneKind : int {
  kReqRows = 7,      // whole rows of the five requirement planes: merged or copied
  kSelect = 0,       // vectors within a row: the row's pick of new or old
  kSelectWords = 1,  // 4-byte words across rows narrower than 4 bytes: a pick a byte
  kUsed = 2,
  kPodCount = 3,
  kPorts = 4,        // bytes
  kPortsWords = 5,   // 4-byte words, a row a whole number of them
  kVolUsed = 6,
};

// one output plane of the commit, as a run of the flat index space
struct Plane {
  int kind;
  int vec;              // kSelect: bytes a vector (16, 8, 4, 2 or 1)
  uint32_t end;         // the flat index one past this plane's last unit
  uint32_t row_units;   // units (vectors, words or elements) a row; kSelectWords: bytes a row
  const void* old_;     // the state's plane
  const void* merged;   // kSelect: what a selected row takes (the old plane for a copy)
  const void* aux;      // kVolUsed: vol_add
  void* out;
};

constexpr int kMaxPlanes = 11;

struct CommitParams {
  Plane plane[kMaxPlanes];
  int n_planes;
  uint32_t total;        // units over every plane
  int n_rows;            // E, rows a tenant
  const int32_t* assigned;   // [B, E]
  const float* req;          // [B, R]
  const uint8_t* cls_ports;  // [B, P]
  const int32_t* per_pod;    // [B, D]
  // the requirement planes (kReqRows): the rows, the class row and the
  // vocabulary they merge with, and the (8, 1) vector path
  kc::MergeShape ms;
  int fixed;
  kc::RowIn rows_in;      // [B, E, K, W] and [B, E, K]
  kc::RowOut rows_out;
  const uint32_t* c_mask;      // [B, K, W]
  const uint8_t* c_def;        // [B, K]
  const uint8_t* c_neg;
  const float* c_gt;
  const float* c_lt;
  const uint32_t* valid;       // [B, K, W]
  const uint32_t* vocab_w;     // [W]
  const float* vocab_ints;     // [B, K, V]
};

// one row's requirement planes: merged with its tenant's class row where
// the row took pods (K3's row code), copied where it did not
__device__ __forceinline__ void commit_req_row(const CommitParams& P, uint32_t row) {
  const int n_keys = P.ms.n_keys;
  const size_t kw = static_cast<size_t>(n_keys) * P.ms.n_words;
  const size_t tb = row / static_cast<uint32_t>(P.n_rows);
  const kc::ClassOps c{P.c_mask + tb * kw, P.c_def + tb * n_keys, P.c_neg + tb * n_keys,
                       P.c_gt + tb * n_keys, P.c_lt + tb * n_keys, P.valid + tb * kw, P.vocab_w,
                       P.vocab_ints + tb * n_keys * static_cast<size_t>(P.ms.n_vocab), nullptr};
  const size_t r = row;
  const kc::RowIn in{P.rows_in.mask + r * kw, P.rows_in.def + r * n_keys,
                     P.rows_in.neg + r * n_keys, P.rows_in.gt + r * n_keys,
                     P.rows_in.lt + r * n_keys};
  const kc::RowOut out{P.rows_out.mask + r * kw, P.rows_out.def + r * n_keys,
                       P.rows_out.neg + r * n_keys, P.rows_out.gt + r * n_keys,
                       P.rows_out.lt + r * n_keys};
  const bool take = P.assigned[row] > 0;
  if (P.fixed) {
    kc::merge_row<8, 1, true, false>(P.ms, c, in, out, take);
  } else {
    kc::merge_row<0, 0, true, false>(P.ms, c, in, out, take);
  }
}

template <typename V>
__device__ __forceinline__ void select_unit(const Plane& p, uint32_t u, const int32_t* assigned) {
  const uint32_t row = u / p.row_units;
  const V* src = static_cast<const V*>(assigned[row] > 0 ? p.merged : p.old_);
  static_cast<V*>(p.out)[u] = src[u];
}

// the parameters stay in the constant bank (__grid_constant__): the plane
// lookup indexes them without a copy to local memory
__global__ void __launch_bounds__(kCommitThreads) existing_commit_kernel(
    const __grid_constant__ CommitParams P) {
  const uint32_t stride = gridDim.x * blockDim.x;
  for (uint32_t g = blockIdx.x * blockDim.x + threadIdx.x; g < P.total; g += stride) {
    int k = 0;
    while (g >= P.plane[k].end) ++k;
    const Plane& p = P.plane[k];
    const uint32_t u = g - (k == 0 ? 0u : P.plane[k - 1].end);
    switch (p.kind) {
      case kReqRows:
        commit_req_row(P, u);
        break;
      case kSelect:
        switch (p.vec) {
          case 16: select_unit<uint4>(p, u, P.assigned); break;
          case 8: select_unit<uint2>(p, u, P.assigned); break;
          case 4: select_unit<uint32_t>(p, u, P.assigned); break;
          case 2: select_unit<uint16_t>(p, u, P.assigned); break;
          default: select_unit<uint8_t>(p, u, P.assigned); break;
        }
        break;
      case kSelectWords: {
        const uint32_t* old_ = static_cast<const uint32_t*>(p.old_);
        const uint32_t* merged = static_cast<const uint32_t*>(p.merged);
        const uint32_t first = 4 * u;
        const uint32_t row = first / p.row_units;
        uint32_t take = P.assigned[row] > 0 ? 0xffffffffu : 0u;  // the bytes from merged
        if ((first + 3) / p.row_units != row) {
          take = 0;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            if (P.assigned[(first + b) / p.row_units] > 0) take |= 0xffu << (8 * b);
          }
        }
        uint32_t v;
        if (take == 0) {
          v = old_[u];
        } else if (take == 0xffffffffu) {
          v = merged[u];
        } else {
          v = (merged[u] & take) | (old_[u] & ~take);
        }
        static_cast<uint32_t*>(p.out)[u] = v;
        break;
      }
      case kUsed: {  // [B*E, R] f32: every row
        const uint32_t row = u / p.row_units;
        const uint32_t r = u - row * p.row_units;
        const uint32_t tb = row / P.n_rows;
        const float a = static_cast<float>(P.assigned[row]);
        static_cast<float*>(p.out)[u] =
            __fmaf_rn(a, P.req[tb * p.row_units + r], static_cast<const float*>(p.old_)[u]);
        break;
      }
      case kPodCount:  // [B*E] i32
        static_cast<int32_t*>(p.out)[u] = wadd(static_cast<const int32_t*>(p.old_)[u],
                                               P.assigned[u]);
        break;
      case kPortsWords: {  // [B*E, P] bool as words, host ports on
        const uint32_t row = u / p.row_units;
        uint32_t v = static_cast<const uint32_t*>(p.old_)[u];
        if (P.assigned[row] > 0) {
          const uint32_t tb = row / P.n_rows;
          v |= reinterpret_cast<const uint32_t*>(
              P.cls_ports)[tb * p.row_units + (u - row * p.row_units)];
        }
        static_cast<uint32_t*>(p.out)[u] = v;
        break;
      }
      case kPorts: {  // [B*E, P] bool, host ports on
        const uint32_t row = u / p.row_units;
        const uint8_t have = static_cast<const uint8_t*>(p.old_)[u];
        uint8_t v = have;
        if (P.assigned[row] > 0) {
          const uint32_t tb = row / P.n_rows;
          v = have | P.cls_ports[tb * p.row_units + (u - row * p.row_units)];
        }
        static_cast<uint8_t*>(p.out)[u] = v;
        break;
      }
      default: {  // kVolUsed: [B*E, D] i32, volume limits on
        const uint32_t row = u / p.row_units;
        const int32_t have = static_cast<const int32_t*>(p.old_)[u];
        const int32_t a = P.assigned[row];
        int32_t v = have;
        if (a > 0) {
          const uint32_t tb = row / P.n_rows;
          v = wadd(wadd(have, static_cast<const int32_t*>(p.aux)[u]),
                   wmul(a, P.per_pod[tb * p.row_units + (u - row * p.row_units)]));
        }
        static_cast<int32_t*>(p.out)[u] = v;
        break;
      }
    }
  }
}

// the widest vector that divides the row and every pointer's alignment
int vector_bytes(long long row_bytes, const void* a, const void* b, const void* c) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
                          reinterpret_cast<uintptr_t>(c);
  for (int v = 16; v > 1; v /= 2) {
    if (row_bytes % v == 0 && align % v == 0) return v;
  }
  return 1;
}

bool aligned(uintptr_t align, const void* a, const void* b, const void* c) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c)) % align) == 0;
}

struct CommitPlan {
  CommitParams P{};
  unsigned long long total = 0;

  void add(int kind, int vec, long long units, long long row_units, const void* old_,
           const void* merged, const void* aux, void* out) {
    if (units <= 0) return;
    total += static_cast<unsigned long long>(units);
    Plane& p = P.plane[P.n_planes++];
    p = Plane{kind, vec, static_cast<uint32_t>(total), static_cast<uint32_t>(row_units),
              old_, merged, aux, out};
  }

  // a plane that takes `merged` on the selected rows (a copy when merged is
  // old): in vectors within a row, else in words across rows, else in bytes
  void select(long long rows, long long row_bytes, const void* old_, const void* merged,
              void* out) {
    const int vec = vector_bytes(row_bytes, old_, merged, out);
    if (vec < 4 && (rows * row_bytes) % 4 == 0 && aligned(4, old_, merged, out)) {
      add(kSelectWords, 4, rows * row_bytes / 4, row_bytes, old_, merged, nullptr, out);
    } else {
      add(kSelect, vec, rows * (row_bytes / vec), row_bytes / vec, old_, merged, nullptr, out);
    }
  }
};

template <int Z>
auto fill_kernel(bool warp) {
  return warp ? existing_mask_fill_kernel<32, Z> : existing_mask_fill_kernel<kFillThreads, Z>;
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

}  // namespace

extern "C" int kc_existing_mask_fill(int n_batch, int n_rows, int n_zones, int has_extra,
                                     int single_node, const void* prep_cap, const void* zone,
                                     const void* cls_zone, const void* restrict_,
                                     const void* extra, const void* quota, void* assigned_out,
                                     void* placed_out, void* zone_ok_out, void* stream) {
  if (n_rows <= 0 || n_batch <= 0) return 0;
  // vector loads and stores: a tenant's rows start on a 16-byte boundary
  // (its zone bytes and extra flags on a 4-byte one)
  const int vec = n_rows % 4 == 0 && aligned(16, prep_cap, assigned_out, assigned_out) &&
                  aligned(4, zone, zone_ok_out, has_extra ? extra : zone);
  // one warp a tenant when its rows fit a warp's tile (the cold path's one
  // dummy row): no block-wide barrier
  const bool warp = n_rows <= 32 * kFillRows;
  auto kernel = fill_kernel<0>(warp);
  if (n_zones == 1) kernel = fill_kernel<1>(warp);
  if (n_zones == 2) kernel = fill_kernel<2>(warp);
  if (n_zones == 3) kernel = fill_kernel<3>(warp);
  if (n_zones == 4) kernel = fill_kernel<4>(warp);
  kernel<<<n_batch, warp ? 32 : kFillThreads, n_zones, static_cast<cudaStream_t>(stream)>>>(
      n_rows, n_zones, has_extra, single_node, vec, static_cast<const int32_t*>(prep_cap),
      static_cast<const uint8_t*>(zone), static_cast<const uint8_t*>(cls_zone),
      static_cast<const uint8_t*>(restrict_), static_cast<const uint8_t*>(extra),
      static_cast<const int32_t*>(quota), static_cast<int32_t*>(assigned_out),
      static_cast<int32_t*>(placed_out), static_cast<uint8_t*>(zone_ok_out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int kc_existing_mask(int n_batch, int n_rows, int n_zones, int has_extra,
                                int single_node,
                                const void* prep_cap, const void* zone, const void* cls_zone,
                                const void* restrict_, const void* extra, void* cap_out,
                                void* priority_out, void* zone_ok_out, void* stream) {
  if (n_rows <= 0 || n_batch <= 0) return 0;
  existing_mask_kernel<<<n_batch, kMaskThreads, n_zones, static_cast<cudaStream_t>(stream)>>>(
      n_rows, n_zones, has_extra, single_node, static_cast<const int32_t*>(prep_cap),
      static_cast<const uint8_t*>(zone), static_cast<const uint8_t*>(cls_zone),
      static_cast<const uint8_t*>(restrict_), static_cast<const uint8_t*>(extra),
      static_cast<int32_t*>(cap_out), static_cast<int32_t*>(priority_out),
      static_cast<uint8_t*>(zone_ok_out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int kc_existing_commit(
    int n_batch, int n_rows, int n_res, int n_keys, int n_words, int n_vocab, int other_word,
    int other_bitpos, int needs_bounds, int n_zones, int n_ct, int n_ports, int n_csi,
    int host_ports, int volume_limits,
    const void* used, const void* kmask, const void* kdef, const void* kneg,
    const void* kgt, const void* klt, const void* zone, const void* ct, const void* ports,
    const void* vol_used, const void* pod_count, const void* c_mask, const void* c_def,
    const void* c_neg, const void* c_gt, const void* c_lt, const void* valid,
    const void* vocab_w, const void* vocab_ints, const void* zone_new,
    const void* ct_ok, const void* cls_ports, const void* vol_add, const void* per_pod,
    const void* req, const void* assigned, void* used_out, void* kmask_out,
    void* kdef_out, void* kneg_out, void* kgt_out, void* klt_out, void* zone_out,
    void* ct_out, void* ports_out, void* vol_used_out, void* pod_count_out,
    void* stream) {
  const long long rows = static_cast<long long>(n_batch) * n_rows;
  if (rows <= 0) return 0;
  if (n_keys < 1 || n_words < 1) return static_cast<int>(cudaErrorInvalidValue);
  CommitPlan b;
  b.P.n_rows = n_rows;
  b.P.assigned = static_cast<const int32_t*>(assigned);
  b.P.req = static_cast<const float*>(req);
  b.P.cls_ports = static_cast<const uint8_t*>(cls_ports);
  b.P.per_pod = static_cast<const int32_t*>(per_pod);
  b.P.ms = kc::MergeShape{n_keys, n_words, n_vocab, other_word, other_bitpos, needs_bounds};
  b.P.rows_in = kc::RowIn{static_cast<const uint32_t*>(kmask), static_cast<const uint8_t*>(kdef),
                          static_cast<const uint8_t*>(kneg), static_cast<const float*>(kgt),
                          static_cast<const float*>(klt)};
  b.P.rows_out = kc::RowOut{static_cast<uint32_t*>(kmask_out), static_cast<uint8_t*>(kdef_out),
                            static_cast<uint8_t*>(kneg_out), static_cast<float*>(kgt_out),
                            static_cast<float*>(klt_out)};
  b.P.c_mask = static_cast<const uint32_t*>(c_mask);
  b.P.c_def = static_cast<const uint8_t*>(c_def);
  b.P.c_neg = static_cast<const uint8_t*>(c_neg);
  b.P.c_gt = static_cast<const float*>(c_gt);
  b.P.c_lt = static_cast<const float*>(c_lt);
  b.P.valid = static_cast<const uint32_t*>(valid);
  b.P.vocab_w = static_cast<const uint32_t*>(vocab_w);
  b.P.vocab_ints = static_cast<const float*>(vocab_ints);
  // the (8, 1) vector path: the row planes start on 16-byte boundaries
  b.P.fixed = n_keys == 8 && n_words == 1 && aligned(16, kmask, kdef, kneg) &&
              aligned(16, kgt, klt, kmask_out) && aligned(16, kdef_out, kneg_out, kgt_out) &&
              aligned(16, klt_out, klt_out, klt_out);
  // the widest planes first: their warps stay whole
  b.add(kReqRows, 0, rows, 1, nullptr, nullptr, nullptr, nullptr);
  b.select(rows, n_zones, zone, zone_new, zone_out);
  b.select(rows, n_ct, ct, ct_ok, ct_out);
  b.add(kUsed, 4, rows * n_res, n_res, used, nullptr, nullptr, used_out);
  b.add(kPodCount, 4, rows, 1, pod_count, nullptr, nullptr, pod_count_out);
  if (host_ports && n_ports % 4 == 0 && aligned(4, ports, cls_ports, ports_out)) {
    b.add(kPortsWords, 4, rows * n_ports / 4, n_ports / 4, ports, nullptr, nullptr, ports_out);
  } else if (host_ports) {
    b.add(kPorts, 1, rows * n_ports, n_ports, ports, nullptr, nullptr, ports_out);
  } else {
    b.select(rows, n_ports, ports, ports, ports_out);
  }
  if (volume_limits) {
    b.add(kVolUsed, 4, rows * n_csi, n_csi, vol_used, nullptr, vol_add, vol_used_out);
  } else {
    b.select(rows, 4LL * n_csi, vol_used, vol_used, vol_used_out);
  }
  if (b.total > 0x7fffffffULL) return static_cast<int>(cudaErrorInvalidValue);
  if (b.total == 0) return 0;
  b.P.total = static_cast<uint32_t>(b.total);
  const unsigned long long want = (b.total + kCommitThreads - 1) / kCommitThreads;
  const unsigned long long cap = static_cast<unsigned long long>(sm_count()) * 8;
  const int blocks = static_cast<int>(want < cap ? want : cap);
  existing_commit_kernel<<<blocks, kCommitThreads, 0, static_cast<cudaStream_t>(stream)>>>(b.P);
  return static_cast<int>(cudaGetLastError());
}
