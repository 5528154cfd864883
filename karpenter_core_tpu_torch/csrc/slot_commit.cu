// K23: the slot commit of one placement phase or zone-committal block.
//
// Replaces the commits of `_phase` (karpenter_core_tpu/ops/solve.py:755-772,
// open slots, and :851-870, fresh slots) and of the fused committal block's
// one-shot commit (:1325-1360): the new-node slot state after a fill's pods
// land.  Every row (b, n) of the slot planes has one source:
//
//   fresh  fresh_t[b,n] >= 0: a slot opened from template t = fresh_t
//   open   otherwise, a[b,n] > 0: an open slot that took pods
//   keep   otherwise
//
// (a tenant the phase skips comes with every row kept: `a` 0 and `fresh_t`
// -1, `kernels/commit.keep_skipped`, vmap's select of a batched `lax.cond`)
// and the planes are, by source (a = a[b,n]; zi = the row's zone set: the
// committal block's zone index zone_idx[b,n], else 0):
//
//   used      open, keep: fma(a, req, used)   fresh: fma(a, req, daemon[t])
//   kmask/kdef/kneg/kgt/klt
//             open: the row merged with the class (K3)   fresh: the template
//             merged with the class
//   zone      open: zone_ok[n] (a phase) or one-hot of zone_idx (committal)
//             fresh: t_zone[t] (a phase) or one-hot of zone_idx (committal)
//   ct        open: ct_ok[n]   fresh: t_ct[t]
//   viable    open: ok[zi][n] & (cap[zi][n] >= a)
//             fresh: t_ok[zi][t] & (t_cap[zi][t] >= a)
//   ports     (host ports on) open: ports | cls_ports   fresh: (a > 0) & cls_ports
//   pod_count open, keep: pod_count + a   fresh: a
//   tmpl_id   fresh: t      open_  fresh: true
//
// and a copy of the input everywhere else.  With
// host ports off the wrapper hands the input `ports` plane back as it is
// (the twin does the same); this kernel then writes no ports plane.  `ok` and
// `cap` are K1's it_ok and cap_ni planes [B, N, I], one pair a zone set (one
// in a phase, Z in the committal block, where K1 ran once a zone); `t_ok` and
// `t_cap` the templates' [B, T, I] pairs.
//
// Bound on the H100: bytes, counted from the rows a call has
// (chip_smoke.py's slot_commit_work).  Every output plane is written once
// (the study's B = 147 x N = 8,192 x I = 1,000 viable plane is 1.2 GB); a
// kept row reads its old rows; an open row that took pods its old small
// planes, its merged rows and its zone set's K1 bool and int32 a type; a
// fresh row nothing old (its rows come from the T templates, read once).
// With the study's heaviest commit (about 154k kept, 441 open and 1.05M
// fresh rows) that is about 1.43 GB, 0.43 ms at 3.35 TB/s.  The torch glue
// this replaces moved every K1 plane in full a zone (ok and cap, 6 GB a
// zone at B = 147) through a chain of selects.
//
// Design: one launch of two kinds of 256-thread blocks.  The viable blocks
// take a row a warp; the row's source, a, t and zone set are read once (one
// address for every lane: a broadcast).  A kept or open row is walked at its
// own flat offset: its 16-byte-aligned body in 16-byte vectors (a kept row a
// plain copy; an open row one vector of its K1 bools and four of its int32
// caps, at the same flat offset as the row's own bytes), its unaligned head
// and tail byte by byte (I = 1,000 is not a multiple of 16, so every other
// row starts 8 bytes off a 16-byte boundary).  A fresh row's template row
// starts elsewhere, so it goes in 4-byte words (I a multiple of 4: one word
// of bools and one 16-byte vector of caps a lane, consecutive lanes on
// consecutive words), else byte by byte, lanes on consecutive bytes.  The
// row blocks take a row's other planes a thread (a few to a few hundred
// bytes a row), every load through the read-only path, so a thread's loads
// need not wait behind its own earlier stores.  Nothing is written to an
// input.
//
// Designs measured before this one (profile_solve.py, H100; the study's
// launches at B = 147 and the cold path's at B = 1, device us a launch):
// the other planes a thread a row with plain loads (1,094.8; 26.9: 32 row
// blocks of about a hundred loads and stores in series a thread), in the
// row's warp (1,885.7; 14.4), an element a thread (1,382.0; 14.5: 19.7M
// threads at B = 147, each finding its row again); the first two gathered a
// fresh row's 16 bytes a lane from lanes 16 bytes apart.
//
// Arithmetic matches the reference bit for bit: `base + a * req` is one
// fused multiply-add rounded once (`__fmaf_rn`), as XLA's CPU code
// contracts the slot commits in the reference's jitted solve; nvcc would
// contract too, but the intrinsic says so.  pod_count + a wraps as int32
// (unsigned arithmetic), as the reference's does.
//
// Measured (profile_solve.py, H100 80GB HBM3 at 700 W): 997.1 us a launch
// over the study's 91 (B = 147: about 2x the bound above), 20.6 us a launch
// on the cold path (B = 1, bound about 3 us: latency).
// ptxas (sm_90a, -O3 -Xptxas -v): 48 registers, no spill, no stack.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxZoneSets = 32;

enum Source : int { kKeep = 0, kOpen = 1, kFresh = 2 };

struct Params {
  long long rows;  // B * N
  int n_rows, n_tmpl, n_res, n_keys, n_words, n_zones, n_ct, n_ports, n_types, n_vz;
  int zone_by_index, vec, vec4;
  long long viable_blocks;
  // the state
  const float* used;
  const uint32_t* kmask;
  const uint8_t* kdef;
  const uint8_t* kneg;
  const float* kgt;
  const float* klt;
  const uint8_t* zone;
  const uint8_t* ct;
  const uint8_t* viable;
  const uint8_t* ports;
  const int32_t* pod_count;
  const int32_t* tmpl_id;
  const uint8_t* open_;
  // the rows' sources
  const int32_t* a;        // [B, N]
  const int32_t* fresh_t;  // [B, N], -1 where the row is not fresh
  const int32_t* zone_idx; // [B, N] (committal) or null
  const uint32_t* m_mask;  // the rows merged with the class [B, N, K, W] ...
  const uint8_t* m_def;
  const uint8_t* m_neg;
  const float* m_gt;
  const float* m_lt;
  const uint32_t* t_mask;  // the templates merged with the class [B, T, K, W] ...
  const uint8_t* t_def;
  const uint8_t* t_neg;
  const float* t_gt;
  const float* t_lt;
  const uint8_t* zone_ok;  // [B, N, Z] (a phase) or null
  const uint8_t* t_zone;   // [B, T, Z] (a phase) or null
  const uint8_t* ct_ok;    // [B, N, CT]
  const uint8_t* t_ct;     // [B, T, CT]
  const uint8_t* ok[kMaxZoneSets];     // [B, N, I] a zone set
  const int32_t* cap[kMaxZoneSets];    // [B, N, I]
  const uint8_t* t_ok[kMaxZoneSets];   // [B, T, I]
  const int32_t* t_cap[kMaxZoneSets];  // [B, T, I]
  const uint8_t* cls_ports;  // [B, P]
  const float* req;          // [B, R]
  const float* daemon;       // [B, T, R]
  // the outputs
  float* used_o;
  uint32_t* kmask_o;
  uint8_t* kdef_o;
  uint8_t* kneg_o;
  float* kgt_o;
  float* klt_o;
  uint8_t* zone_o;
  uint8_t* ct_o;
  uint8_t* viable_o;
  uint8_t* ports_o;  // null with host ports off
  int32_t* pod_count_o;
  int32_t* tmpl_id_o;
  uint8_t* open_o;
};

__device__ __forceinline__ int row_source(int32_t a, int32_t t) {
  if (t >= 0) return kFresh;
  return a > 0 ? kOpen : kKeep;
}

__device__ __forceinline__ int zone_set(const Params& P, long long r) {
  if (P.zone_by_index == 0) return 0;
  const int32_t z = P.zone_idx[r];
  return z >= 0 && z < P.n_vz ? z : 0;
}

// bytes j of the four words of `w` AND (cap >= a): 16 viable bytes
__device__ __forceinline__ uint32_t word_ok(uint32_t w, int4 c, int32_t a) {
  return (w & 0x000000ffu & (c.x >= a ? 0xffffffffu : 0u)) |
         (w & 0x0000ff00u & (c.y >= a ? 0xffffffffu : 0u)) |
         (w & 0x00ff0000u & (c.z >= a ? 0xffffffffu : 0u)) |
         (w & 0xff000000u & (c.w >= a ? 0xffffffffu : 0u));
}

// one row's viable plane, one warp: `okp`/`capp` its source planes at flat
// offset `sbase` (capp null: a copy of okp at the row's own offset)
__device__ __forceinline__ void viable_row(const Params& P, size_t base, int src, int32_t a,
                                           const uint8_t* okp, const int32_t* capp,
                                           size_t sbase, int lane) {
  const size_t n_types = static_cast<size_t>(P.n_types);
  uint8_t* out = P.viable_o + base;
  if (src == kFresh) {
    // the template row starts elsewhere than the row: 4-byte words where
    // both start on one (lanes on consecutive words: coalesced), else bytes
    if (P.vec4) {
      const size_t words = n_types / 4;
      const uint32_t* ow = reinterpret_cast<const uint32_t*>(okp + sbase);
      const int4* cw = reinterpret_cast<const int4*>(capp + sbase);
      uint32_t* dst = reinterpret_cast<uint32_t*>(out);
      for (size_t w = lane; w < words; w += 32) dst[w] = word_ok(__ldg(ow + w), __ldg(cw + w), a);
    } else {
      for (size_t col = lane; col < n_types; col += 32) {
        out[col] = static_cast<uint8_t>(__ldg(okp + sbase + col) != 0 &&
                                        __ldg(capp + sbase + col) >= a);
      }
    }
    return;
  }
  // a kept or open row reads at its own flat offset.  head: up to the row's
  // first 16-byte boundary (the whole row when the planes are not all
  // 16-byte aligned); body: whole vectors; tail: the rest
  size_t head = n_types;
  if (P.vec) {
    const size_t lead = (16 - (base & 15)) & 15;
    head = lead < n_types ? lead : n_types;
  }
  const size_t body = (n_types - head) / 16;
  const size_t tail = head + 16 * body;
  auto one_byte = [&](size_t col) {
    const uint8_t o = __ldg(okp + base + col);
    out[col] = capp == nullptr ? o
                               : static_cast<uint8_t>(o != 0 && __ldg(capp + base + col) >= a);
  };
  for (size_t col = lane; col < head; col += 32) one_byte(col);
  for (size_t col = tail + lane; col < n_types; col += 32) one_byte(col);
  for (size_t k = lane; k < body; k += 32) {
    const size_t col = head + 16 * k;
    const uint4 o = __ldg(reinterpret_cast<const uint4*>(okp + base + col));
    uint4 v = o;
    if (capp != nullptr) {
      const int4* c = reinterpret_cast<const int4*>(capp + base + col);
      v = make_uint4(word_ok(o.x, __ldg(c), a), word_ok(o.y, __ldg(c + 1), a),
                     word_ok(o.z, __ldg(c + 2), a), word_ok(o.w, __ldg(c + 3), a));
    }
    *reinterpret_cast<uint4*>(out + col) = v;
  }
}

struct RowSource {
  int b, src, zi;
  int32_t a, t;
  size_t tr;  // the fresh row's template row (b * T + t)
};

__device__ __forceinline__ RowSource row_of(const Params& P, long long r) {
  RowSource s;
  s.b = static_cast<int>(r / P.n_rows);
  s.a = __ldg(P.a + r);
  s.t = __ldg(P.fresh_t + r);
  s.src = row_source(s.a, s.t);
  s.zi = s.src == kOpen || s.src == kFresh ? zone_set(P, r) : 0;
  s.tr = s.src == kFresh ? static_cast<size_t>(s.b) * P.n_tmpl + s.t : 0;
  return s;
}

// the viable plane of row r, one warp
__device__ __forceinline__ void commit_viable(const Params& P, long long r, int lane) {
  const RowSource s = row_of(P, r);
  const size_t n_types = static_cast<size_t>(P.n_types);
  const size_t base = static_cast<size_t>(r) * n_types;
  if (s.src == kOpen) {
    viable_row(P, base, s.src, s.a, P.ok[s.zi], P.cap[s.zi], base, lane);
  } else if (s.src == kFresh) {
    viable_row(P, base, s.src, s.a, P.t_ok[s.zi], P.t_cap[s.zi], s.tr * n_types, lane);
  } else {
    viable_row(P, base, s.src, s.a, P.viable, nullptr, base, lane);
  }
}

// every other plane of row r, one thread.  Its loads go through the
// read-only path: nothing here writes a plane it reads, so they need not
// wait behind the row's earlier stores.
__device__ __forceinline__ void small_row(const Params& P, long long r) {
  const RowSource s = row_of(P, r);
  const size_t rr = static_cast<size_t>(r);
  const bool took = s.src == kOpen || s.src == kFresh;

  const int n_res = P.n_res;
  const float af = static_cast<float>(s.a);
  const float* req = P.req + static_cast<size_t>(s.b) * n_res;
  for (int j = 0; j < n_res; ++j) {
    const size_t i = rr * n_res + j;
    float v;
    if (s.src == kFresh) {
      v = __fmaf_rn(af, __ldg(req + j), __ldg(P.daemon + s.tr * n_res + j));
    } else {
      v = __fmaf_rn(af, __ldg(req + j), __ldg(P.used + i));
    }
    P.used_o[i] = v;
  }

  // the requirement planes: the merged row, the merged template, or the row
  const int n_keys = P.n_keys;
  const size_t kw = static_cast<size_t>(n_keys) * P.n_words;
  const size_t row = s.src == kFresh ? s.tr : rr;
  const uint32_t* mask = (s.src == kOpen ? P.m_mask : s.src == kFresh ? P.t_mask : P.kmask);
  const uint8_t* def = (s.src == kOpen ? P.m_def : s.src == kFresh ? P.t_def : P.kdef);
  const uint8_t* neg = (s.src == kOpen ? P.m_neg : s.src == kFresh ? P.t_neg : P.kneg);
  const float* gt = (s.src == kOpen ? P.m_gt : s.src == kFresh ? P.t_gt : P.kgt);
  const float* lt = (s.src == kOpen ? P.m_lt : s.src == kFresh ? P.t_lt : P.klt);
  for (size_t j = 0; j < kw; ++j) P.kmask_o[rr * kw + j] = __ldg(mask + row * kw + j);
  for (int k = 0; k < n_keys; ++k) {
    const size_t i = row * n_keys + k;
    const size_t o = rr * n_keys + k;
    P.kdef_o[o] = __ldg(def + i);
    P.kneg_o[o] = __ldg(neg + i);
    P.kgt_o[o] = __ldg(gt + i);
    P.klt_o[o] = __ldg(lt + i);
  }

  const int n_zones = P.n_zones;
  const int32_t zhot = took && P.zone_by_index ? __ldg(P.zone_idx + r) : -1;
  for (int z = 0; z < n_zones; ++z) {
    const size_t i = rr * n_zones + z;
    uint8_t v;
    if (!took) {
      v = __ldg(P.zone + i);
    } else if (P.zone_by_index) {
      v = z == zhot ? 1 : 0;
    } else {
      v = s.src == kOpen ? __ldg(P.zone_ok + i) : __ldg(P.t_zone + s.tr * n_zones + z);
    }
    P.zone_o[i] = v;
  }
  const int n_ct = P.n_ct;
  for (int c = 0; c < n_ct; ++c) {
    const size_t i = rr * n_ct + c;
    P.ct_o[i] = s.src == kOpen    ? __ldg(P.ct_ok + i)
                : s.src == kFresh ? __ldg(P.t_ct + s.tr * n_ct + c)
                                  : __ldg(P.ct + i);
  }
  if (P.ports_o != nullptr) {  // host ports on
    const int n_ports = P.n_ports;
    for (int p = 0; p < n_ports; ++p) {
      const size_t i = rr * n_ports + p;
      const uint8_t cls = __ldg(P.cls_ports + static_cast<size_t>(s.b) * n_ports + p);
      uint8_t v;
      if (s.src == kOpen) {
        v = static_cast<uint8_t>(__ldg(P.ports + i) | cls);
      } else if (s.src == kFresh) {
        v = static_cast<uint8_t>(s.a > 0 && cls != 0);
      } else {
        v = __ldg(P.ports + i);
      }
      P.ports_o[i] = v;
    }
  }
  int32_t count = __ldg(P.pod_count + r);
  if (s.src == kFresh) {
    count = s.a;
  } else {
    count = static_cast<int32_t>(static_cast<uint32_t>(count) + static_cast<uint32_t>(s.a));
  }
  P.pod_count_o[r] = count;
  P.tmpl_id_o[r] = s.src == kFresh ? s.t : __ldg(P.tmpl_id + r);
  P.open_o[r] = s.src == kFresh ? 1 : __ldg(P.open_ + r);
}

// the parameters stay in the constant bank (__grid_constant__): the zone-set
// lookup indexes them without a copy to local memory
__global__ void __launch_bounds__(kThreads) slot_commit_kernel(const __grid_constant__ Params P) {
  if (static_cast<long long>(blockIdx.x) < P.viable_blocks) {
    const long long r = static_cast<long long>(blockIdx.x) * kWarps + threadIdx.x / 32;
    if (r < P.rows) commit_viable(P, r, threadIdx.x & 31);
  } else {
    const long long r =
        (static_cast<long long>(blockIdx.x) - P.viable_blocks) * kThreads + threadIdx.x;
    if (r < P.rows) small_row(P, r);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

// Pointer arguments in the order of `Params`; `ok`, `cap`, `t_ok` and `t_cap`
// are host arrays of n_vz device pointers each.  Returns the launch's
// cudaError_t.
extern "C" int kc_slot_commit(
    int n_batch, int n_rows, int n_tmpl, int n_res, int n_keys, int n_words, int n_zones,
    int n_ct, int n_ports, int n_types, int n_vz, int zone_by_index,
    const void* used, const void* kmask, const void* kdef, const void* kneg, const void* kgt,
    const void* klt, const void* zone, const void* ct, const void* viable, const void* ports,
    const void* pod_count, const void* tmpl_id, const void* open_,
    const void* a, const void* fresh_t, const void* zone_idx,
    const void* m_mask, const void* m_def, const void* m_neg, const void* m_gt,
    const void* m_lt, const void* t_mask, const void* t_def, const void* t_neg,
    const void* t_gt, const void* t_lt, const void* zone_ok, const void* t_zone,
    const void* ct_ok, const void* t_ct, const void* const* ok, const void* const* cap,
    const void* const* t_ok, const void* const* t_cap, const void* cls_ports, const void* req,
    const void* daemon, void* used_o, void* kmask_o, void* kdef_o, void* kneg_o, void* kgt_o,
    void* klt_o, void* zone_o, void* ct_o, void* viable_o, void* ports_o, void* pod_count_o,
    void* tmpl_id_o, void* open_o, void* stream) {
  const long long rows = static_cast<long long>(n_batch) * n_rows;
  if (rows <= 0) return 0;
  if (n_vz < 1 || n_vz > kMaxZoneSets || n_keys < 1 || n_words < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (zone_by_index ? zone_idx == nullptr : (zone_ok == nullptr || t_zone == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params P{};
  P.rows = rows;
  P.n_rows = n_rows;
  P.n_tmpl = n_tmpl;
  P.n_res = n_res;
  P.n_keys = n_keys;
  P.n_words = n_words;
  P.n_zones = n_zones;
  P.n_ct = n_ct;
  P.n_ports = n_ports;
  P.n_types = n_types;
  P.n_vz = n_vz;
  P.zone_by_index = zone_by_index;
  P.used = static_cast<const float*>(used);
  P.kmask = static_cast<const uint32_t*>(kmask);
  P.kdef = static_cast<const uint8_t*>(kdef);
  P.kneg = static_cast<const uint8_t*>(kneg);
  P.kgt = static_cast<const float*>(kgt);
  P.klt = static_cast<const float*>(klt);
  P.zone = static_cast<const uint8_t*>(zone);
  P.ct = static_cast<const uint8_t*>(ct);
  P.viable = static_cast<const uint8_t*>(viable);
  P.ports = static_cast<const uint8_t*>(ports);
  P.pod_count = static_cast<const int32_t*>(pod_count);
  P.tmpl_id = static_cast<const int32_t*>(tmpl_id);
  P.open_ = static_cast<const uint8_t*>(open_);
  P.a = static_cast<const int32_t*>(a);
  P.fresh_t = static_cast<const int32_t*>(fresh_t);
  P.zone_idx = static_cast<const int32_t*>(zone_idx);
  P.m_mask = static_cast<const uint32_t*>(m_mask);
  P.m_def = static_cast<const uint8_t*>(m_def);
  P.m_neg = static_cast<const uint8_t*>(m_neg);
  P.m_gt = static_cast<const float*>(m_gt);
  P.m_lt = static_cast<const float*>(m_lt);
  P.t_mask = static_cast<const uint32_t*>(t_mask);
  P.t_def = static_cast<const uint8_t*>(t_def);
  P.t_neg = static_cast<const uint8_t*>(t_neg);
  P.t_gt = static_cast<const float*>(t_gt);
  P.t_lt = static_cast<const float*>(t_lt);
  P.zone_ok = static_cast<const uint8_t*>(zone_ok);
  P.t_zone = static_cast<const uint8_t*>(t_zone);
  P.ct_ok = static_cast<const uint8_t*>(ct_ok);
  P.t_ct = static_cast<const uint8_t*>(t_ct);
  // 16-byte vectors over the viable rows' bodies: the planes read and
  // written at the rows' own flat offsets all start on a 16-byte boundary
  bool vec = aligned16(viable) && aligned16(viable_o);
  for (int z = 0; z < n_vz; ++z) {
    P.ok[z] = static_cast<const uint8_t*>(ok[z]);
    P.cap[z] = static_cast<const int32_t*>(cap[z]);
    P.t_ok[z] = static_cast<const uint8_t*>(t_ok[z]);
    P.t_cap[z] = static_cast<const int32_t*>(t_cap[z]);
    vec = vec && aligned16(ok[z]) && aligned16(cap[z]);
  }
  P.vec = vec ? 1 : 0;
  // a fresh row in 4-byte words: every template row and slot row starts on
  // a word (I a multiple of 4), the caps' words on 16 bytes
  bool vec4 = n_types % 4 == 0 && aligned16(viable_o);
  for (int z = 0; z < n_vz; ++z) vec4 = vec4 && aligned16(t_ok[z]) && aligned16(t_cap[z]);
  P.vec4 = vec4 ? 1 : 0;
  P.cls_ports = static_cast<const uint8_t*>(cls_ports);
  P.req = static_cast<const float*>(req);
  P.daemon = static_cast<const float*>(daemon);
  P.used_o = static_cast<float*>(used_o);
  P.kmask_o = static_cast<uint32_t*>(kmask_o);
  P.kdef_o = static_cast<uint8_t*>(kdef_o);
  P.kneg_o = static_cast<uint8_t*>(kneg_o);
  P.kgt_o = static_cast<float*>(kgt_o);
  P.klt_o = static_cast<float*>(klt_o);
  P.zone_o = static_cast<uint8_t*>(zone_o);
  P.ct_o = static_cast<uint8_t*>(ct_o);
  P.viable_o = static_cast<uint8_t*>(viable_o);
  P.ports_o = static_cast<uint8_t*>(ports_o);
  P.pod_count_o = static_cast<int32_t*>(pod_count_o);
  P.tmpl_id_o = static_cast<int32_t*>(tmpl_id_o);
  P.open_o = static_cast<uint8_t*>(open_o);
  const long long viable_blocks = (rows + kWarps - 1) / kWarps;
  const long long row_blocks = (rows + kThreads - 1) / kThreads;
  if (viable_blocks + row_blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  P.viable_blocks = viable_blocks;
  slot_commit_kernel<<<static_cast<unsigned>(viable_blocks + row_blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}
