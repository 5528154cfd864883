// K12: the warm repair's window scatter.
//
// Replaces `_scatter_repair_window_impl` (karpenter_core_tpu/ops/solve.py:
// 2070): the windowed repair's final carry is written back over a COPY of
// the full-width carry (which stays as it was):
//
//   out_plane[n, :] = w_plane[s, :]  where idx[s] == n, else plane[n, :]
//                                          for each of the 13 NodeState planes
//   fwd_out[g, n]   = w_fwd[g, s]    where idx[s] == n, else fwd[g, n]  (and inv)
//   n_next_out      = n_next + (w_n_next - n_open_w)   (int32 wrap, on the card)
//
// The existing-node state and the limit budget are the window's, replaced
// whole by the caller (the repair is their only writer).  `idx` holds unique
// slots, so no two window rows land on one output row.
//
// Bound on the H100: bytes.  It reads and writes every row of the
// full-width planes (about 1.1 KB a slot; 9 MB each way at N = 8,192, the
// bool viable plane over 1,000 types most of it) plus the window: about
// 19 MB, 5.6 us at 3.35 TB/s.
// Design: ONE launch over tiles of 16 consecutive slots.  A tile's block
// first finds which window row, if any, lands on each of its slots (its
// threads scan `idx`, at most S = 512 entries, into 16 shared entries),
// then streams each plane's contiguous tile (16 rows) from the window or
// the full plane row by row, 4-byte words where the row's bytes and the
// addresses allow, else bytes; then the topology columns of its slots.
//
// K22, `kc_repair_scatter_inplace`, replaces `scatter_repair_window_donated`
// (ops/solve.py:2115, the same body with the full-width carry donated): the
// window's rows go into the full-width carry's own storage and nothing else
// is touched, so its grid covers the window's S slots, not N.  One block a
// window row s writes the 13 planes' row idx[s] (4-byte words where the row
// and the addresses allow, else bytes), then the fwd_new / inv_new columns
// idx[s]; block 0 advances n_next where it lies.  The existing-node state
// and the budget are the window carry's, swapped in by the caller.  Bound:
// bytes, S rows of the 13 planes read from the window and written into the
// carry, 2 G1 S int32 each way, idx and n_next: at S = 512 about 1.2 MB,
// 0.36 us at 3.35 TB/s.  The full-width pointers are written where they
// lie and carry no `__restrict__`.  `idx` must hold unique slots (the
// reference relies on it too): two window rows on one slot would race.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 16;
constexpr int kMaxPlanes = 16;
constexpr int kInplaceThreads = 128;

struct Planes {
  const uint8_t* full[kMaxPlanes];
  const uint8_t* win[kMaxPlanes];
  uint8_t* dst[kMaxPlanes];
  int row_bytes[kMaxPlanes];
  int n;
};

__device__ __forceinline__ bool word_aligned(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 4 == 0;
}

__global__ void __launch_bounds__(kThreads) repair_scatter_kernel(
    Planes planes, int n_slots, int n_window, int g1, int n_open_w,
    const int32_t* __restrict__ idx, const int32_t* __restrict__ fwd,
    const int32_t* __restrict__ inv, const int32_t* __restrict__ n_next,
    const int32_t* __restrict__ w_fwd, const int32_t* __restrict__ w_inv,
    const int32_t* __restrict__ w_n_next, int32_t* __restrict__ fwd_out,
    int32_t* __restrict__ inv_out, int32_t* __restrict__ n_next_out) {
  __shared__ int from_window[kTile];
  const int n0 = blockIdx.x * kTile;
  const int rows = min(kTile, n_slots - n0);
  if (threadIdx.x < kTile) from_window[threadIdx.x] = -1;
  __syncthreads();
  for (int s = threadIdx.x; s < n_window; s += blockDim.x) {
    const int d = idx[s] - n0;
    if (d >= 0 && d < rows) from_window[d] = s;
  }
  __syncthreads();

  for (int p = 0; p < planes.n; ++p) {
    const int rb = planes.row_bytes[p];
    const uint8_t* full = planes.full[p];
    const uint8_t* win = planes.win[p];
    uint8_t* dst = planes.dst[p];
    const bool words = rb % 4 == 0 && word_aligned(full) && word_aligned(win) &&
                       word_aligned(dst);
    if (words) {
      const int row_words = rb / 4;
      for (int i = threadIdx.x; i < rows * row_words; i += blockDim.x) {
        const int r = i / row_words, k = i - r * row_words;
        const int s = from_window[r];
        const uint32_t* src = s >= 0
            ? reinterpret_cast<const uint32_t*>(win) + (size_t)s * row_words
            : reinterpret_cast<const uint32_t*>(full) + (size_t)(n0 + r) * row_words;
        reinterpret_cast<uint32_t*>(dst)[(size_t)(n0 + r) * row_words + k] = src[k];
      }
    } else {
      for (int i = threadIdx.x; i < rows * rb; i += blockDim.x) {
        const int r = i / rb, k = i - r * rb;
        const int s = from_window[r];
        const uint8_t* src = s >= 0 ? win + (size_t)s * rb : full + (size_t)(n0 + r) * rb;
        dst[(size_t)(n0 + r) * rb + k] = src[k];
      }
    }
  }
  for (int i = threadIdx.x; i < g1 * rows; i += blockDim.x) {
    const int g = i / rows, r = i - g * rows;
    const int s = from_window[r];
    const size_t at = (size_t)g * n_slots + n0 + r;
    fwd_out[at] = s >= 0 ? w_fwd[(size_t)g * n_window + s] : fwd[at];
    inv_out[at] = s >= 0 ? w_inv[(size_t)g * n_window + s] : inv[at];
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    const uint32_t opened = static_cast<uint32_t>(*w_n_next) - static_cast<uint32_t>(n_open_w);
    *n_next_out = static_cast<int32_t>(static_cast<uint32_t>(*n_next) + opened);
  }
}

__global__ void __launch_bounds__(kInplaceThreads) repair_scatter_inplace_kernel(
    Planes planes, int n_slots, int n_window, int g1, int n_open_w, const int32_t* idx,
    int32_t* fwd, int32_t* inv, int32_t* n_next, const int32_t* w_fwd,
    const int32_t* w_inv, const int32_t* w_n_next) {
  const int s = blockIdx.x;
  const int n = idx[s];
  for (int p = 0; p < planes.n; ++p) {
    const int rb = planes.row_bytes[p];
    const uint8_t* src = planes.win[p] + (size_t)s * rb;
    uint8_t* dst = planes.dst[p] + (size_t)n * rb;
    if (rb % 4 == 0 && word_aligned(src) && word_aligned(dst)) {
      for (int k = threadIdx.x; k < rb / 4; k += blockDim.x) {
        reinterpret_cast<uint32_t*>(dst)[k] = reinterpret_cast<const uint32_t*>(src)[k];
      }
    } else {
      for (int k = threadIdx.x; k < rb; k += blockDim.x) dst[k] = src[k];
    }
  }
  for (int g = threadIdx.x; g < g1; g += blockDim.x) {
    fwd[(size_t)g * n_slots + n] = w_fwd[(size_t)g * n_window + s];
    inv[(size_t)g * n_slots + n] = w_inv[(size_t)g * n_window + s];
  }
  if (s == 0 && threadIdx.x == 0) {
    const uint32_t opened = static_cast<uint32_t>(*w_n_next) - static_cast<uint32_t>(n_open_w);
    *n_next = static_cast<int32_t>(static_cast<uint32_t>(*n_next) + opened);
  }
}

}  // namespace

extern "C" int kc_repair_scatter(
    int n_planes, const void* const* fulls, const void* const* wins, void* const* dsts,
    const int* row_bytes, int n_slots, int n_window, int g1, int n_open_w, const void* idx,
    const void* fwd, const void* inv, const void* n_next, const void* w_fwd,
    const void* w_inv, const void* w_n_next, void* fwd_out, void* inv_out, void* n_next_out,
    void* stream) {
  if (n_planes > kMaxPlanes) return static_cast<int>(cudaErrorInvalidValue);
  Planes planes;
  planes.n = n_planes;
  for (int p = 0; p < n_planes; ++p) {
    planes.full[p] = static_cast<const uint8_t*>(fulls[p]);
    planes.win[p] = static_cast<const uint8_t*>(wins[p]);
    planes.dst[p] = static_cast<uint8_t*>(dsts[p]);
    planes.row_bytes[p] = row_bytes[p];
  }
  if (n_slots <= 0) return 0;
  const int blocks = (n_slots + kTile - 1) / kTile;
  repair_scatter_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      planes, n_slots, n_window, g1, n_open_w, static_cast<const int32_t*>(idx),
      static_cast<const int32_t*>(fwd), static_cast<const int32_t*>(inv),
      static_cast<const int32_t*>(n_next), static_cast<const int32_t*>(w_fwd),
      static_cast<const int32_t*>(w_inv), static_cast<const int32_t*>(w_n_next),
      static_cast<int32_t*>(fwd_out), static_cast<int32_t*>(inv_out),
      static_cast<int32_t*>(n_next_out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int kc_repair_scatter_inplace(
    int n_planes, void* const* fulls, const void* const* wins, const int* row_bytes,
    int n_slots, int n_window, int g1, int n_open_w, const void* idx, void* fwd, void* inv,
    void* n_next, const void* w_fwd, const void* w_inv, const void* w_n_next, void* stream) {
  if (n_planes > kMaxPlanes) return static_cast<int>(cudaErrorInvalidValue);
  Planes planes;
  planes.n = n_planes;
  for (int p = 0; p < n_planes; ++p) {
    planes.full[p] = static_cast<const uint8_t*>(fulls[p]);
    planes.win[p] = static_cast<const uint8_t*>(wins[p]);
    planes.dst[p] = static_cast<uint8_t*>(fulls[p]);
    planes.row_bytes[p] = row_bytes[p];
  }
  if (n_window <= 0) return 0;
  repair_scatter_inplace_kernel<<<n_window, kInplaceThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      planes, n_slots, n_window, g1, n_open_w, static_cast<const int32_t*>(idx),
      static_cast<int32_t*>(fwd), static_cast<int32_t*>(inv), static_cast<int32_t*>(n_next),
      static_cast<const int32_t*>(w_fwd), static_cast<const int32_t*>(w_inv),
      static_cast<const int32_t*>(w_n_next));
  return static_cast<int>(cudaGetLastError());
}
