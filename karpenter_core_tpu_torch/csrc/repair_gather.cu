// K11: the warm repair's window gather.
//
// Replaces `gather_repair_window` (karpenter_core_tpu/ops/solve.py:2016):
// a bounded repair touches only the S new-node slots `idx` (the freed
// holes, any open filler, then the fresh tail), so the full-width carry's
// per-slot planes are cut down to those rows and the new-slot topology
// counts to those columns:
//
//   w_plane[s, :]  = plane[idx[s], :]     for each of the 13 NodeState planes
//   fwd_w[g, s]    = fwd[g, idx[s]];  inv_w[g, s] = inv[g, idx[s]]
//   n_next_w       = n_open_w             (written here: no host round trip)
//
// and the zone counts of every OPEN slot outside the window, which the
// windowed scan adds back as constants, are summed exactly in int32:
//
//   excl[n]     = open_[n] & (n not in idx);  zone_i[n, z] = zone[n, z] & excl[n]
//   sing[n, z]  = zone_i[n, z] where sum_z zone_i[n, z] == 1, else 0
//   base_sing[g, z] = sum_n fwd[g, n] * sing[n, z]
//   base_fwd[g, z]  = sum_n fwd[g, n] * zone_i[n, z]
//   base_inv[g, z]  = sum_n inv[g, n] * zone_i[n, z]
//
// Bound on the H100: bytes.  At the headline tick (N = 8,192 slots, S = 256
// to 512, I = 1,000 types, G1 = 8, Z = 3) it reads S rows of every plane
// (about 1.1 KB a row, the viable plane's 1,000 bytes most of it) and
// writes them, and reads the open, zone and two topology planes for the
// bases: about 1.8 MB at S = 512, 0.5 us at 3.35 TB/s.
// Design: ONE launch of S + G1 blocks.  Block s < S copies window row s of
// every plane (4-byte words where the row's bytes and both addresses
// allow, else bytes: a 3-zone bool row is 3 bytes) and column s of the two
// topology planes.  Block S + g builds a bitmap of the window in shared
// memory (N / 8 bytes), then its threads stride over the slots summing the
// 3 x Z counts of group g in registers, and reduce them through shared
// memory.  The sums run unsigned: int32 wrap, in any order, as the
// reference's einsums give.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPlanes = 16;
constexpr int kMaxZones = 8;

struct Planes {
  const uint8_t* src[kMaxPlanes];
  uint8_t* dst[kMaxPlanes];
  int row_bytes[kMaxPlanes];
  int n;
};

__device__ __forceinline__ void copy_row(const uint8_t* src, uint8_t* dst, int bytes) {
  const bool words = (bytes % 4 == 0) && (reinterpret_cast<uintptr_t>(src) % 4 == 0) &&
                     (reinterpret_cast<uintptr_t>(dst) % 4 == 0);
  if (words) {
    const uint32_t* s = reinterpret_cast<const uint32_t*>(src);
    uint32_t* d = reinterpret_cast<uint32_t*>(dst);
    for (int i = threadIdx.x; i < bytes / 4; i += blockDim.x) d[i] = s[i];
  } else {
    for (int i = threadIdx.x; i < bytes; i += blockDim.x) dst[i] = src[i];
  }
}

__global__ void __launch_bounds__(kThreads) repair_gather_kernel(
    Planes planes, int n_slots, int n_window, int g1, int n_zones, int n_open_w,
    const int32_t* __restrict__ idx, const int32_t* __restrict__ fwd,
    const int32_t* __restrict__ inv, const uint8_t* __restrict__ zone,
    const uint8_t* __restrict__ open_, int32_t* __restrict__ n_next_out,
    int32_t* __restrict__ fwd_w, int32_t* __restrict__ inv_w, int32_t* __restrict__ base_sing,
    int32_t* __restrict__ base_fwd, int32_t* __restrict__ base_inv) {
  extern __shared__ uint32_t in_window[];  // bitmap of the window's slots
  __shared__ uint32_t sums[3 * kMaxZones];

  if (blockIdx.x < n_window) {
    const int s = blockIdx.x;
    const size_t n = static_cast<size_t>(idx[s]);
    for (int p = 0; p < planes.n; ++p) {
      const size_t rb = static_cast<size_t>(planes.row_bytes[p]);
      copy_row(planes.src[p] + n * rb, planes.dst[p] + s * rb, planes.row_bytes[p]);
    }
    for (int g = threadIdx.x; g < g1; g += blockDim.x) {
      fwd_w[(size_t)g * n_window + s] = fwd[(size_t)g * n_slots + n];
      inv_w[(size_t)g * n_window + s] = inv[(size_t)g * n_slots + n];
    }
    if (s == 0 && threadIdx.x == 0) *n_next_out = n_open_w;
    return;
  }

  // the out-of-window zone counts of group g
  const int g = blockIdx.x - n_window;
  const int words = (n_slots + 31) / 32;
  for (int i = threadIdx.x; i < words; i += blockDim.x) in_window[i] = 0;
  for (int i = threadIdx.x; i < 3 * kMaxZones; i += blockDim.x) sums[i] = 0;
  __syncthreads();
  for (int s = threadIdx.x; s < n_window; s += blockDim.x) {
    const uint32_t n = static_cast<uint32_t>(idx[s]);
    atomicOr(&in_window[n >> 5], 1u << (n & 31));
  }
  __syncthreads();

  uint32_t acc_sing[kMaxZones], acc_fwd[kMaxZones], acc_inv[kMaxZones];
#pragma unroll
  for (int z = 0; z < kMaxZones; ++z) acc_sing[z] = acc_fwd[z] = acc_inv[z] = 0;
  const int32_t* fwd_g = fwd + (size_t)g * n_slots;
  const int32_t* inv_g = inv + (size_t)g * n_slots;
  for (int n = threadIdx.x; n < n_slots; n += blockDim.x) {
    const bool excl = open_[n] && !((in_window[n >> 5] >> (n & 31)) & 1u);
    if (!excl) continue;
    const uint32_t f = static_cast<uint32_t>(fwd_g[n]);
    const uint32_t v = static_cast<uint32_t>(inv_g[n]);
    int zsum = 0;
#pragma unroll
    for (int z = 0; z < kMaxZones; ++z) {
      if (z < n_zones) zsum += zone[(size_t)n * n_zones + z] ? 1 : 0;
    }
#pragma unroll
    for (int z = 0; z < kMaxZones; ++z) {
      if (z < n_zones && zone[(size_t)n * n_zones + z]) {
        acc_fwd[z] += f;
        acc_inv[z] += v;
        if (zsum == 1) acc_sing[z] += f;
      }
    }
  }
#pragma unroll
  for (int z = 0; z < kMaxZones; ++z) {
    if (z >= n_zones) continue;
    uint32_t a = acc_sing[z], b = acc_fwd[z], c = acc_inv[z];
    for (int off = 16; off > 0; off >>= 1) {
      a += __shfl_down_sync(0xffffffffu, a, off);
      b += __shfl_down_sync(0xffffffffu, b, off);
      c += __shfl_down_sync(0xffffffffu, c, off);
    }
    if ((threadIdx.x & 31) == 0) {
      atomicAdd(&sums[z], a);
      atomicAdd(&sums[kMaxZones + z], b);
      atomicAdd(&sums[2 * kMaxZones + z], c);
    }
  }
  __syncthreads();
  for (int z = threadIdx.x; z < n_zones; z += blockDim.x) {
    base_sing[g * n_zones + z] = static_cast<int32_t>(sums[z]);
    base_fwd[g * n_zones + z] = static_cast<int32_t>(sums[kMaxZones + z]);
    base_inv[g * n_zones + z] = static_cast<int32_t>(sums[2 * kMaxZones + z]);
  }
}

}  // namespace

extern "C" int kc_repair_gather(
    int n_planes, const void* const* srcs, void* const* dsts, const int* row_bytes,
    int n_slots, int n_window, int g1, int n_zones, int n_open_w, const void* idx,
    const void* fwd, const void* inv, const void* zone, const void* open_, void* n_next_out,
    void* fwd_w, void* inv_w, void* base_sing, void* base_fwd, void* base_inv, void* stream) {
  if (n_planes > kMaxPlanes || n_zones > kMaxZones) return static_cast<int>(cudaErrorInvalidValue);
  Planes planes;
  planes.n = n_planes;
  for (int p = 0; p < n_planes; ++p) {
    planes.src[p] = static_cast<const uint8_t*>(srcs[p]);
    planes.dst[p] = static_cast<uint8_t*>(dsts[p]);
    planes.row_bytes[p] = row_bytes[p];
  }
  const int blocks = n_window + g1;
  if (blocks <= 0) return 0;
  const size_t shared = static_cast<size_t>((n_slots + 31) / 32) * sizeof(uint32_t);
  repair_gather_kernel<<<blocks, kThreads, shared, static_cast<cudaStream_t>(stream)>>>(
      planes, n_slots, n_window, g1, n_zones, n_open_w, static_cast<const int32_t*>(idx),
      static_cast<const int32_t*>(fwd), static_cast<const int32_t*>(inv),
      static_cast<const uint8_t*>(zone), static_cast<const uint8_t*>(open_),
      static_cast<int32_t*>(n_next_out), static_cast<int32_t*>(fwd_w),
      static_cast<int32_t*>(inv_w), static_cast<int32_t*>(base_sing),
      static_cast<int32_t*>(base_fwd), static_cast<int32_t*>(base_inv));
  return static_cast<int>(cudaGetLastError());
}
