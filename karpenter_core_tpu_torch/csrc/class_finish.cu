// K15: device-side class finishing — the compact class rows padded into the
// bucket on the card.
//
// Replaces `_cls_finish_fn` / `finish_class_planes_device`
// (karpenter_core_tpu/ops/solve.py:2623, :2655), the jitted pad/scatter the
// reference runs under KC_ENCODE_DEVICE_FINISH=1: the host ships the C exact
// class rows and the sixteen ClassTensors planes are padded on the device,
// cell for cell as pad_planes' host branch pads them.  Every plane is viewed
// as [C, A, B] (K and the vocabulary for the requirement mask, K for the
// per-key planes, the last axis for the rest) and each output cell is
//   c >= C_old                  -> the plane's class fill
//   a >= A_old                  -> its key fill (undefined keys: mask True)
//   mask: b <  V_old            -> source b
//         V_old <= b < V_new    -> False (new vocabulary slots)
//         b == V_new            -> source V_old (the trailing "unseen" slot)
//   else: b >= B_old            -> its last-axis fill (ports: False)
//   groups: source g >= G1_old - 1 becomes G1_new - 1 (the "none" group)
//
// Bound on the H100: bytes, and far below a launch at the headline's
// shapes (C 13 -> 16, K 1 -> 8, I = 1,000: about 20 KB written).  Design:
// one launch for all sixteen planes; the plane table rides in the launch
// parameters; blockIdx.y picks the plane, each thread writes one output cell
// (1 or 4 bytes, fills carried as bit patterns).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPlanes = 16;
constexpr int kThreads = 256;

struct Plane {
  const void* src;
  void* dst;
  int elem;  // bytes per cell: 1 or 4
  int c_old, a_old, b_old, c_new, a_new, b_new;
  int widen;  // the requirement mask's vocabulary widening
  uint32_t fill_c, fill_a, fill_b;
  int remap;  // groups: values >= remap_from become remap_to
  int remap_from, remap_to;
};

struct Table {
  Plane p[kPlanes];
};

__global__ void __launch_bounds__(kThreads) class_finish_kernel(Table table) {
  const Plane& pl = table.p[blockIdx.y];
  const long long cells = (long long)pl.c_new * pl.a_new * pl.b_new;
  const long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= cells) return;
  const int b = static_cast<int>(o % pl.b_new);
  const int a = static_cast<int>((o / pl.b_new) % pl.a_new);
  const int c = static_cast<int>(o / ((long long)pl.b_new * pl.a_new));
  uint32_t v;
  int sb = -1;
  if (c >= pl.c_old) {
    v = pl.fill_c;
  } else if (a >= pl.a_old) {
    v = pl.fill_a;
  } else if (pl.widen) {
    const int v_old = pl.b_old - 1, v_new = pl.b_new - 1;
    if (b < v_old) sb = b;
    else if (b == v_new) sb = v_old;
    v = pl.fill_b;
  } else {
    if (b < pl.b_old) sb = b;
    v = pl.fill_b;
  }
  if (sb >= 0) {
    const long long s = ((long long)c * pl.a_old + a) * pl.b_old + sb;
    if (pl.elem == 1) {
      v = static_cast<const uint8_t*>(pl.src)[s];
    } else {
      v = static_cast<const uint32_t*>(pl.src)[s];
      if (pl.remap && static_cast<int32_t>(v) >= pl.remap_from) v = static_cast<uint32_t>(pl.remap_to);
    }
  }
  if (pl.elem == 1) {
    static_cast<uint8_t*>(pl.dst)[o] = static_cast<uint8_t>(v);
  } else {
    static_cast<uint32_t*>(pl.dst)[o] = v;
  }
}

}  // namespace

extern "C" int kc_class_finish_planes() { return kPlanes; }

// `spec` holds, for each of the 16 planes, 14 int32s: elem, c_old, a_old,
// b_old, c_new, a_new, b_new, widen, fill_c, fill_a, fill_b (bit patterns),
// remap, remap_from, remap_to; `src` and `dst` the planes' device pointers.
extern "C" int kc_class_finish(const int32_t* spec, const void* const* src, void* const* dst,
                               void* stream) {
  Table table;
  long long most = 0;
  for (int i = 0; i < kPlanes; ++i) {
    const int32_t* s = spec + 14 * i;
    Plane& p = table.p[i];
    p.src = src[i];
    p.dst = dst[i];
    p.elem = s[0];
    p.c_old = s[1]; p.a_old = s[2]; p.b_old = s[3];
    p.c_new = s[4]; p.a_new = s[5]; p.b_new = s[6];
    p.widen = s[7];
    p.fill_c = static_cast<uint32_t>(s[8]);
    p.fill_a = static_cast<uint32_t>(s[9]);
    p.fill_b = static_cast<uint32_t>(s[10]);
    p.remap = s[11]; p.remap_from = s[12]; p.remap_to = s[13];
    const long long cells = (long long)p.c_new * p.a_new * p.b_new;
    if (cells > most) most = cells;
  }
  if (most <= 0) return 0;
  const dim3 grid(static_cast<unsigned>((most + kThreads - 1) / kThreads), kPlanes);
  class_finish_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(table);
  return static_cast<int>(cudaGetLastError());
}
