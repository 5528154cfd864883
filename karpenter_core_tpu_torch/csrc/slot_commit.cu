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
//   used      open: fma(a, req, used)   fresh: fma(a, req, daemon[t])
//   kmask/kdef/kneg/kgt/klt
//             open: the row merged with the class (K3)   fresh: the template
//             merged with the class
//   zone      open: zone_ok[n] (a phase) or one-hot of zone_idx (committal)
//             fresh: t_zone[t] (a phase) or one-hot of zone_idx (committal)
//   ct        open: ct_ok[n]   fresh: t_ct[t]
//   viable    open: ok[zi][n] & (cap[zi][n] >= a)
//             fresh: t_ok[zi][t] & (t_cap[zi][t] >= a)
//   ports     (host ports on) open: ports | cls_ports   fresh: (a > 0) & cls_ports
//   pod_count open: pod_count + a   fresh: a
//   tmpl_id   fresh: t      open_  fresh: true
//
// IN PLACE: the state planes are both the input and the output.  A kept row
// is neither read nor written (the reference's `fma(0, req, used)` of a kept
// row equals `used`: no slot's usage is -0.0 or meets an infinite request),
// an open row reads and writes its own row, a fresh row reads nothing old.
// With host ports off this kernel writes no ports plane.  `ok` and `cap` are
// K1's it_ok and cap_ni planes [B, N, I], one pair a zone set (one in a
// phase, Z in the committal block, where K1 ran once a zone); `t_ok` and
// `t_cap` the templates' [B, T, I] pairs.
//
// Bound on the H100: bytes, counted from the rows a call has
// (chip_smoke.py's slot_commit_work): every row's source (`a`, `fresh_t`,
// `zone_idx`: 8-12 bytes); an open row's old small planes, merged rows and
// K1 bool and int32 a type read, its row written; a fresh row's row written
// (1,040 bytes at the study's I = 1,000, K = 1); the templates once.  The
// study's heaviest commit (441 open, 1,049,433 fresh and 154,350 kept rows
// at B = 147, N = 8,192) moves about 1.1 GB, 0.33 ms at 3.35 TB/s; a commit
// of kept rows only moves its 9.6 MB of sources, about 3 us.
//
// Design: a persistent grid of 128-thread blocks, as many as the SMs hold
// at once; each warp walks tiles of 32 rows a grid's warps apart, reading
// the `a` and `fresh_t` of four tiles at once, coalesced, and finding the
// rows that took pods by ballot: a tile of kept rows costs those 256 bytes.
//   - Fresh rows come in runs: consecutive rows of one tenant opened from one
//     template with one pod count and zone (`_phase`'s slots n_next.. with
//     `per_node` pods each, the last with the rest), all one row image.  The
//     warp builds the run's image once a tile into shared memory: the viable
//     row (the template's it_ok & (cap >= a)) followed by its first 32 bytes
//     again, and each small plane's row.  The viable span over the run's
//     rows is periodic with I, so the warp stores it in aligned 16-byte
//     vectors, the vector at address X holding image bytes (X - span start)
//     mod I onward, read as two aligned 16-byte shared loads and a funnel
//     shift, whatever 16-byte phase each row starts at (every other row at
//     I = 1,000); each lane copies its own row's small planes from the image.
//   - An open row's viable plane is walked by the warp at the row's own flat
//     offset (16-byte vectors of K1 bools and int32 caps over its aligned
//     body, bytes at head and tail), its small planes by its own lane.
//   - Kept rows are skipped.
// Measured (profile_commit.py, H100 80GB HBM3 at 700 W, device ms a launch):
// 0.4283-0.4310 on the study's heaviest commit (1.30x its 0.3306 ms bound; a
// fill_ of the same bytes 0.3398), 0.0181-0.0185 on its commit of fewest
// rows (bound 0.0042), 0.0189-0.0193 on the cold path's (B = 1, bound 0.0025;
// an empty launch of this kernel 0.0054).  Every smaller grid tried made
// the heaviest commit slower, so the grid takes every warp the SMs hold.
// ptxas (sm_90a, -O3 -Xptxas -v): 72 registers, 20 bytes spilled.
//
// Measured before this one (the same commits; heaviest / fewest rows):
// the first, out of place, every row of every plane written (a warp a row's
// viable plane, a thread a row's other planes through the read-only path,
// fresh rows in 4-byte words: 0.8351 / 1.0145, its viable blocks 0.8027 /
// 0.9295 alone; 997.1 us a launch over the study, 20.6 at B = 1; its three
// out-of-place predecessors in PERF.md); in place: small planes as periodic
// spans too, sources a tile at a time (0.4500 / 0.0265) or four at a time
// (0.4433-0.4516 / 0.0173-0.0179, B = 1 0.0214-0.0219); with the viable
// spans as TMA bulk stores of row pairs (cp.async.bulk, 2,000 bytes, from a
// rotated image: 0.5875 / 0.0409); two or four consecutive tiles a warp
// (0.4753, 0.4638), a tile queue on an atomic counter (0.4843), a warp's
// tiles contiguous (0.4649), 256-thread blocks (0.4918), 8 blocks an SM
// by launch bounds (0.4551), a grid of 1/7, 2/7 or 4/7 of the SMs' room
// (1.157, 0.6899, 0.5640); a block of four warps on one tile (1.1684 /
// 0.0256, B = 1 0.0160); small commits split a tile between warps (0.4655,
// B = 1 0.0208); an open row's small planes a warp a row (0.4573 / 0.0246).
//
// Arithmetic matches the reference bit for bit: `base + a * req` is one
// fused multiply-add rounded once (`__fmaf_rn`), as XLA's CPU code
// contracts the slot commits in the reference's jitted solve; nvcc would
// contract too, but the intrinsic says so.  pod_count + a wraps as int32
// (unsigned arithmetic), as the reference's does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxZoneSets = 32;
constexpr int kWrap = 32;  // bytes repeated after the viable row's image
constexpr int kGroup = 4;  // tiles whose sources a warp reads at once
constexpr unsigned kFull = 0xffffffffu;

// the planes of a fresh run's row image in a warp's shared buffer, and
// the offset of each there
enum ImageId : int { kUsed, kMask, kGt, kLt, kDef, kNeg, kZone, kCt, kPorts, kViable, kImages };

struct Params {
  int rows;  // B * N
  int n_rows, n_tmpl, n_res, n_keys, n_words, n_zones, n_ct, n_ports, n_types, n_vz;
  int zone_by_index, host_ports, vec, tmpl_vec4, img_bytes;
  int img[kImages];
  // the state, written in place (an open row reads its own old row)
  float* used;
  uint32_t* kmask;
  uint8_t* kdef;
  uint8_t* kneg;
  float* kgt;
  float* klt;
  uint8_t* zone;
  uint8_t* ct;
  uint8_t* viable;
  uint8_t* ports;  // null with host ports off
  int32_t* pod_count;
  int32_t* tmpl_id;
  uint8_t* open_;
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
};

// what every row of a fresh run shares
struct RunKey {
  int b, t, a, z;  // z: the raw zone index (committal), else 0
};

__device__ __forceinline__ bool same_key(const RunKey& x, const RunKey& y) {
  return x.b == y.b && x.t == y.t && x.a == y.a && x.z == y.z;
}

__device__ __forceinline__ int zone_set(const Params& P, int z) {
  return z >= 0 && z < P.n_vz ? z : 0;
}

// bytes j of the four words of `w` AND (cap >= a): 16 viable bytes
__device__ __forceinline__ uint32_t word_ok(uint32_t w, int4 c, int32_t a) {
  return (w & 0x000000ffu & (c.x >= a ? 0xffffffffu : 0u)) |
         (w & 0x0000ff00u & (c.y >= a ? 0xffffffffu : 0u)) |
         (w & 0x00ff0000u & (c.z >= a ? 0xffffffffu : 0u)) |
         (w & 0xff000000u & (c.w >= a ? 0xffffffffu : 0u));
}

// 16 image bytes from byte j on (j < width; the buffer holds width + 32)
__device__ __forceinline__ uint4 image16(const uint8_t* img, uint32_t j) {
  const uint4* v = reinterpret_cast<const uint4*>(img) + (j >> 4);
  const uint4 lo = v[0], hi = v[1];
  const uint32_t o = (j >> 2) & 3, s = (j & 3) * 8;
  const uint32_t w0 = o == 0 ? lo.x : o == 1 ? lo.y : o == 2 ? lo.z : lo.w;
  const uint32_t w1 = o == 0 ? lo.y : o == 1 ? lo.z : o == 2 ? lo.w : hi.x;
  const uint32_t w2 = o == 0 ? lo.z : o == 1 ? lo.w : o == 2 ? hi.x : hi.y;
  const uint32_t w3 = o == 0 ? lo.w : o == 1 ? hi.x : o == 2 ? hi.y : hi.z;
  const uint32_t w4 = o == 0 ? hi.x : o == 1 ? hi.y : o == 2 ? hi.z : hi.w;
  return make_uint4(__funnelshift_r(w0, w1, s), __funnelshift_r(w1, w2, s),
                    __funnelshift_r(w2, w3, s), __funnelshift_r(w3, w4, s));
}

// bytes [0, n) of `dst`, a span of whole rows of `width` bytes each equal to
// `img`: aligned 16-byte vectors over the body, bytes at head and tail
__device__ __forceinline__ void store_periodic(uint8_t* dst, long long n, int width,
                                               const uint8_t* img, int lane) {
  if (n <= 0) return;
  const uintptr_t s = reinterpret_cast<uintptr_t>(dst);
  const uintptr_t e = s + static_cast<uintptr_t>(n);
  const uintptr_t a0 = (s + 15) & ~static_cast<uintptr_t>(15);
  const uintptr_t a1 = e & ~static_cast<uintptr_t>(15);
  const unsigned w = static_cast<unsigned>(width);
  if (a0 >= a1) {  // no whole vector (under 31 bytes)
    for (long long x = lane; x < n; x += 32) dst[x] = img[static_cast<unsigned>(x) % w];
    return;
  }
  const unsigned head = static_cast<unsigned>(a0 - s), tail = static_cast<unsigned>(e - a1);
  if (static_cast<unsigned>(lane) < head) dst[lane] = img[static_cast<unsigned>(lane) % w];
  if (lane >= 16 && static_cast<unsigned>(lane - 16) < tail) {
    const unsigned long long x = (a1 - s) + static_cast<unsigned>(lane - 16);
    dst[x] = img[x % w];
  }
  const long long nv = static_cast<long long>((a1 - a0) >> 4);
  const unsigned step = 512u % w;
  unsigned j = (head + 16u * static_cast<unsigned>(lane)) % w;
  uint4* out = reinterpret_cast<uint4*>(a0);
  for (long long v = lane; v < nv; v += 32) {
    out[v] = image16(img, j);
    j += step;
    if (j >= w) j -= w;
  }
}

// a fresh run's row image into the warp's buffer `img`: each small plane's
// row, and the viable row followed by its first kWrap bytes again (its
// periodic reads run past the row's end)
__device__ __forceinline__ void build_images(const Params& P, uint8_t* img, const RunKey& k,
                                             int lane) {
  __syncwarp();  // every lane is done reading the previous images
  const size_t tr = static_cast<size_t>(k.b) * P.n_tmpl + k.t;
  const int n_res = P.n_res, n_keys = P.n_keys;
  const float af = static_cast<float>(k.a);
  float* used = reinterpret_cast<float*>(img + P.img[kUsed]);
  for (int j = lane; j < n_res; j += 32) {
    used[j] = __fmaf_rn(af, __ldg(P.req + static_cast<size_t>(k.b) * n_res + j),
                        __ldg(P.daemon + tr * n_res + j));
  }
  const int kw = n_keys * P.n_words;
  uint32_t* mask = reinterpret_cast<uint32_t*>(img + P.img[kMask]);
  for (int j = lane; j < kw; j += 32) mask[j] = __ldg(P.t_mask + tr * kw + j);
  float* gt = reinterpret_cast<float*>(img + P.img[kGt]);
  float* lt = reinterpret_cast<float*>(img + P.img[kLt]);
  uint8_t* def = img + P.img[kDef];
  uint8_t* neg = img + P.img[kNeg];
  for (int j = lane; j < n_keys; j += 32) {
    const size_t i = tr * n_keys + j;
    def[j] = __ldg(P.t_def + i);
    neg[j] = __ldg(P.t_neg + i);
    gt[j] = __ldg(P.t_gt + i);
    lt[j] = __ldg(P.t_lt + i);
  }
  uint8_t* zone = img + P.img[kZone];
  for (int j = lane; j < P.n_zones; j += 32) {
    zone[j] = P.zone_by_index ? static_cast<uint8_t>(j == k.z)
                              : __ldg(P.t_zone + tr * P.n_zones + j);
  }
  uint8_t* ct = img + P.img[kCt];
  for (int j = lane; j < P.n_ct; j += 32) ct[j] = __ldg(P.t_ct + tr * P.n_ct + j);
  if (P.host_ports) {
    uint8_t* ports = img + P.img[kPorts];
    for (int j = lane; j < P.n_ports; j += 32) {
      ports[j] = static_cast<uint8_t>(
          k.a > 0 && __ldg(P.cls_ports + static_cast<size_t>(k.b) * P.n_ports + j) != 0);
    }
  }
  // the viable row: the template's it_ok & (cap >= a) of the run's zone set
  const int zs = P.zone_by_index ? zone_set(P, k.z) : 0;
  const size_t n_types = static_cast<size_t>(P.n_types);
  const uint8_t* okp = P.t_ok[zs] + tr * n_types;
  const int32_t* capp = P.t_cap[zs] + tr * n_types;
  uint8_t* v = img + P.img[kViable];
  if (P.tmpl_vec4) {  // I a multiple of 4: a word of bools and a vector of caps a lane
    const uint32_t* ow = reinterpret_cast<const uint32_t*>(okp);
    const int4* cw = reinterpret_cast<const int4*>(capp);
    uint32_t* vw = reinterpret_cast<uint32_t*>(v);
    for (size_t w = lane; w < n_types / 4; w += 32) vw[w] = word_ok(__ldg(ow + w), __ldg(cw + w), k.a);
  } else {
    for (size_t j = lane; j < n_types; j += 32) {
      v[j] = static_cast<uint8_t>(__ldg(okp + j) != 0 && __ldg(capp + j) >= k.a);
    }
  }
  __syncwarp();
  v[n_types + lane] = v[static_cast<unsigned>(lane) % static_cast<unsigned>(n_types)];
  __syncwarp();
}

// fresh row r's small planes from the run's row image, one lane
__device__ __forceinline__ void fresh_small(const Params& P, const uint8_t* img, const RunKey& k,
                                            int r) {
  const size_t rr = static_cast<size_t>(r);
  const float* used = reinterpret_cast<const float*>(img + P.img[kUsed]);
  for (int j = 0; j < P.n_res; ++j) P.used[rr * P.n_res + j] = used[j];
  const int kw = P.n_keys * P.n_words;
  const uint32_t* mask = reinterpret_cast<const uint32_t*>(img + P.img[kMask]);
  for (int j = 0; j < kw; ++j) P.kmask[rr * kw + j] = mask[j];
  const float* gt = reinterpret_cast<const float*>(img + P.img[kGt]);
  const float* lt = reinterpret_cast<const float*>(img + P.img[kLt]);
  const uint8_t* def = img + P.img[kDef];
  const uint8_t* neg = img + P.img[kNeg];
  for (int j = 0; j < P.n_keys; ++j) {
    const size_t i = rr * P.n_keys + j;
    P.kgt[i] = gt[j];
    P.klt[i] = lt[j];
    P.kdef[i] = def[j];
    P.kneg[i] = neg[j];
  }
  const uint8_t* zone = img + P.img[kZone];
  for (int j = 0; j < P.n_zones; ++j) P.zone[rr * P.n_zones + j] = zone[j];
  const uint8_t* ct = img + P.img[kCt];
  for (int j = 0; j < P.n_ct; ++j) P.ct[rr * P.n_ct + j] = ct[j];
  if (P.host_ports) {
    const uint8_t* ports = img + P.img[kPorts];
    for (int j = 0; j < P.n_ports; ++j) P.ports[rr * P.n_ports + j] = ports[j];
  }
  P.pod_count[r] = k.a;
  P.tmpl_id[r] = k.t;
  P.open_[r] = 1;
}

// rows [r0, r1) of one fresh run, the lanes' own rows among them (`mine`):
// the viable span from its row image, a lane its row's other planes
__device__ __forceinline__ void store_run(const Params& P, uint8_t* img, RunKey& cached,
                                          const RunKey& k, int r0, int r1, int r, int lane) {
  if (!same_key(cached, k)) {
    build_images(P, img, k, lane);
    cached = k;
  }
  store_periodic(P.viable + static_cast<size_t>(r0) * P.n_types,
                 static_cast<long long>(r1 - r0) * P.n_types, P.n_types, img + P.img[kViable],
                 lane);
  if (r >= r0 && r < r1) fresh_small(P, img, k, r);
}

// an open row's viable plane, one warp, at the row's own flat offset: its
// 16-byte-aligned body in vectors (one of K1 bools and four of int32 caps),
// head and tail byte by byte (the whole row when the planes are not all
// 16-byte aligned)
__device__ __forceinline__ void open_viable(const Params& P, int r, int32_t a, int zs, int lane) {
  const size_t n_types = static_cast<size_t>(P.n_types);
  const size_t base = static_cast<size_t>(r) * n_types;
  const uint8_t* okp = P.ok[zs];
  const int32_t* capp = P.cap[zs];
  uint8_t* out = P.viable + base;
  size_t head = n_types;
  if (P.vec) {
    const size_t lead = (16 - (base & 15)) & 15;
    head = lead < n_types ? lead : n_types;
  }
  const size_t body = (n_types - head) / 16;
  const size_t tail = head + 16 * body;
  auto one_byte = [&](size_t col) {
    out[col] = static_cast<uint8_t>(__ldg(okp + base + col) != 0 && __ldg(capp + base + col) >= a);
  };
  for (size_t col = lane; col < head; col += 32) one_byte(col);
  for (size_t col = tail + lane; col < n_types; col += 32) one_byte(col);
  for (size_t k = lane; k < body; k += 32) {
    const size_t col = head + 16 * k;
    const uint4 o = __ldg(reinterpret_cast<const uint4*>(okp + base + col));
    const int4* c = reinterpret_cast<const int4*>(capp + base + col);
    *reinterpret_cast<uint4*>(out + col) =
        make_uint4(word_ok(o.x, __ldg(c), a), word_ok(o.y, __ldg(c + 1), a),
                   word_ok(o.z, __ldg(c + 2), a), word_ok(o.w, __ldg(c + 3), a));
  }
}

// an open row's other planes, one thread: its own old used, ports and pod
// count read and written, the merged, zone and ct rows of the class copied
__device__ __forceinline__ void open_small(const Params& P, int r, int b, int32_t a, int z) {
  const size_t rr = static_cast<size_t>(r);
  const int n_res = P.n_res;
  const float af = static_cast<float>(a);
  for (int j = 0; j < n_res; ++j) {
    const size_t i = rr * n_res + j;
    P.used[i] = __fmaf_rn(af, __ldg(P.req + static_cast<size_t>(b) * n_res + j), P.used[i]);
  }
  const int n_keys = P.n_keys;
  const size_t kw = static_cast<size_t>(n_keys) * P.n_words;
  for (size_t j = 0; j < kw; ++j) P.kmask[rr * kw + j] = __ldg(P.m_mask + rr * kw + j);
  for (int k = 0; k < n_keys; ++k) {
    const size_t i = rr * n_keys + k;
    P.kdef[i] = __ldg(P.m_def + i);
    P.kneg[i] = __ldg(P.m_neg + i);
    P.kgt[i] = __ldg(P.m_gt + i);
    P.klt[i] = __ldg(P.m_lt + i);
  }
  for (int j = 0; j < P.n_zones; ++j) {
    const size_t i = rr * P.n_zones + j;
    P.zone[i] = P.zone_by_index ? static_cast<uint8_t>(j == z) : __ldg(P.zone_ok + i);
  }
  for (int c = 0; c < P.n_ct; ++c) {
    const size_t i = rr * P.n_ct + c;
    P.ct[i] = __ldg(P.ct_ok + i);
  }
  if (P.host_ports) {
    for (int p = 0; p < P.n_ports; ++p) {
      const size_t i = rr * P.n_ports + p;
      P.ports[i] = static_cast<uint8_t>(
          P.ports[i] | __ldg(P.cls_ports + static_cast<size_t>(b) * P.n_ports + p));
    }
  }
  P.pod_count[r] = static_cast<int32_t>(static_cast<uint32_t>(P.pod_count[r]) +
                                        static_cast<uint32_t>(a));
}

// one tile of 32 rows from row r0 on, its sources `a` and `t` (a lane a row)
__device__ __forceinline__ void commit_tile(const Params& P, uint8_t* img, RunKey& cached,
                                            int r0, int32_t a, int32_t t, int lane) {
  const int r = r0 + lane;
  const bool fresh = t >= 0;
  const bool open = !fresh && a > 0;
  if (__ballot_sync(kFull, fresh || open) == 0) return;  // kept rows only
  const int b = fresh || open ? r / P.n_rows : 0;
  const int z = (fresh || open) && P.zone_by_index ? __ldg(P.zone_idx + r) : 0;
  // the fresh runs of this tile, one after another
  const unsigned fm = __ballot_sync(kFull, fresh);
  unsigned left = fm;
  while (left) {
    const int s = __ffs(left) - 1;
    const RunKey k{__shfl_sync(kFull, b, s), __shfl_sync(kFull, t, s),
                   __shfl_sync(kFull, a, s), __shfl_sync(kFull, z, s)};
    const bool same = fresh && b == k.b && t == k.t && a == k.a && z == k.z;
    const unsigned stop = __ballot_sync(kFull, !same) & (kFull << s);
    const int e = stop ? __ffs(stop) - 1 : 32;
    store_run(P, img, cached, k, r0 + s, r0 + e, r, lane);
    left = e < 32 ? fm & (kFull << e) : 0;
  }
  // the open rows that took pods: viable a warp a row, the rest a lane a row
  unsigned om = __ballot_sync(kFull, open);
  while (om) {
    const int l = __ffs(om) - 1;
    om &= om - 1;
    open_viable(P, r0 + l, __shfl_sync(kFull, a, l),
                P.zone_by_index ? zone_set(P, __shfl_sync(kFull, z, l)) : 0, lane);
  }
  if (open) open_small(P, r, b, a, z);
}

// the four tiles first + g * step: their sources read at once (a kept tile
// costs a round trip to memory otherwise), then each committed
__device__ __forceinline__ void commit_group(const Params& P, uint8_t* img, RunKey& cached,
                                             int first, int step, int n_tiles, int lane) {
  int32_t a[kGroup], t[kGroup];
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
    const long long r = (static_cast<long long>(first) + g * step) * 32 + lane;
    const bool valid = r < P.rows;
    a[g] = valid ? __ldg(P.a + r) : 0;
    t[g] = valid ? __ldg(P.fresh_t + r) : -1;
  }
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
    const long long tile = static_cast<long long>(first) + g * step;
    if (tile < n_tiles) commit_tile(P, img, cached, static_cast<int>(tile) * 32, a[g], t[g], lane);
  }
}

// the parameters stay in the constant bank (__grid_constant__): the zone-set
// and plane lookups index them without a copy to local memory
__global__ void __launch_bounds__(kThreads) slot_commit_kernel(const __grid_constant__ Params P) {
  extern __shared__ uint4 smem[];
  const int lane = threadIdx.x & 31;
  uint8_t* img = reinterpret_cast<uint8_t*>(smem) + (threadIdx.x / 32) * P.img_bytes;
  RunKey cached{-1, -1, 0, 0};
  const int n_tiles = (P.rows + 31) / 32;
  // a warp's tiles lie a grid's warps apart
  const int stride = gridDim.x * kWarps;
  for (int first = blockIdx.x * kWarps + threadIdx.x / 32; first < n_tiles;
       first += kGroup * stride) {
    commit_group(P, img, cached, first, stride, n_tiles, lane);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

int round16(int x) { return (x + 15) & ~15; }

// blocks of `smem` dynamic shared bytes the current device holds at once,
// over all its SMs (the device's answers kept from its first launch)
cudaError_t resident_blocks(int smem, int* blocks) {
  constexpr int kDevices = 64;
  static int n_sm[kDevices], smem_max[kDevices], last_smem[kDevices], last_blocks[kDevices];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= kDevices) return cudaErrorInvalidDevice;
  if (n_sm[device] == 0) {
    int sms = 0, optin = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    }
    if (err != cudaSuccess) return err;
    smem_max[device] = optin;
    n_sm[device] = sms;
  }
  if (smem > smem_max[device]) return cudaErrorInvalidValue;
  if (last_blocks[device] > 0 && last_smem[device] == smem) {
    *blocks = last_blocks[device];
    return cudaSuccess;
  }
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(slot_commit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_max[device]);
    if (err != cudaSuccess) return err;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, slot_commit_kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  *blocks = n_sm[device] * (per_sm > 0 ? per_sm : 1);
  last_smem[device] = smem;
  last_blocks[device] = *blocks;
  return cudaSuccess;
}

}  // namespace

// State pointers in the order of `Params` (written in place; `ports` null
// with host ports off), then the sources; `ok`, `cap`, `t_ok` and `t_cap`
// are host arrays of n_vz device pointers each.  Returns the launch's
// cudaError_t.
extern "C" int kc_slot_commit(
    int n_batch, int n_rows, int n_tmpl, int n_res, int n_keys, int n_words, int n_zones,
    int n_ct, int n_ports, int n_types, int n_vz, int zone_by_index,
    void* used, void* kmask, void* kdef, void* kneg, void* kgt, void* klt, void* zone, void* ct,
    void* viable, void* ports, void* pod_count, void* tmpl_id, void* open_,
    const void* a, const void* fresh_t, const void* zone_idx,
    const void* m_mask, const void* m_def, const void* m_neg, const void* m_gt,
    const void* m_lt, const void* t_mask, const void* t_def, const void* t_neg,
    const void* t_gt, const void* t_lt, const void* zone_ok, const void* t_zone,
    const void* ct_ok, const void* t_ct, const void* const* ok, const void* const* cap,
    const void* const* t_ok, const void* const* t_cap, const void* cls_ports, const void* req,
    const void* daemon, void* stream) {
  const long long rows = static_cast<long long>(n_batch) * n_rows;
  if (rows <= 0) return 0;
  if (rows > 0x7fffffe0LL || n_vz < 1 || n_vz > kMaxZoneSets || n_keys < 1 || n_words < 1 ||
      n_res < 1 || n_zones < 1 || n_ct < 1 || n_ports < 1 || n_types < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (zone_by_index ? zone_idx == nullptr : (zone_ok == nullptr || t_zone == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params P{};
  P.rows = static_cast<int>(rows);
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
  P.host_ports = ports != nullptr;
  P.used = static_cast<float*>(used);
  P.kmask = static_cast<uint32_t*>(kmask);
  P.kdef = static_cast<uint8_t*>(kdef);
  P.kneg = static_cast<uint8_t*>(kneg);
  P.kgt = static_cast<float*>(kgt);
  P.klt = static_cast<float*>(klt);
  P.zone = static_cast<uint8_t*>(zone);
  P.ct = static_cast<uint8_t*>(ct);
  P.viable = static_cast<uint8_t*>(viable);
  P.ports = static_cast<uint8_t*>(ports);
  P.pod_count = static_cast<int32_t*>(pod_count);
  P.tmpl_id = static_cast<int32_t*>(tmpl_id);
  P.open_ = static_cast<uint8_t*>(open_);
  // each image's bytes in a warp's buffer, 16-byte aligned; the viable
  // row's kWrap more
  const int image_bytes[kImages] = {4 * n_res, 4 * n_keys * n_words, 4 * n_keys, 4 * n_keys,
                                    n_keys, n_keys, n_zones, n_ct, n_ports, n_types + kWrap};
  int img_bytes = 0;
  for (int i = 0; i < kImages; ++i) {
    P.img[i] = img_bytes;
    img_bytes += round16(image_bytes[i]);
  }
  P.img_bytes = img_bytes;
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
  // 16-byte vectors over an open row's viable body: the planes read and
  // written at the rows' own flat offsets all start on a 16-byte boundary;
  // a template's row image in words: I a multiple of 4, caps on 16 bytes
  bool vec = aligned16(viable);
  bool tmpl_vec4 = n_types % 4 == 0;
  for (int z = 0; z < n_vz; ++z) {
    P.ok[z] = static_cast<const uint8_t*>(ok[z]);
    P.cap[z] = static_cast<const int32_t*>(cap[z]);
    P.t_ok[z] = static_cast<const uint8_t*>(t_ok[z]);
    P.t_cap[z] = static_cast<const int32_t*>(t_cap[z]);
    vec = vec && aligned16(ok[z]) && aligned16(cap[z]);
    tmpl_vec4 = tmpl_vec4 && aligned16(t_ok[z]) && aligned16(t_cap[z]);
  }
  P.vec = vec ? 1 : 0;
  P.tmpl_vec4 = tmpl_vec4 ? 1 : 0;
  P.cls_ports = static_cast<const uint8_t*>(cls_ports);
  P.req = static_cast<const float*>(req);
  P.daemon = static_cast<const float*>(daemon);

  // the persistent grid: as many blocks as the SMs hold at once, fewer
  // where the tiles are fewer
  const int smem = kWarps * img_bytes;
  int per_sm = 0;
  const cudaError_t err = resident_blocks(smem, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long tiles = (rows + 31) / 32;
  long long grid = per_sm;
  const long long needed = (tiles + kWarps - 1) / kWarps;
  if (needed < grid) grid = needed;
  slot_commit_kernel<<<static_cast<unsigned>(grid), kThreads, static_cast<size_t>(smem),
                       static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}
