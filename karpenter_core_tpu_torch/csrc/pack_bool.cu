// K4: bit-pack a bool plane for the decode fetch.
//
// Replaces `pack_bool` (karpenter_core_tpu/ops/solve.py:2121), the jnp
// program that packs the final viable [N, I], zone [N, Z] and capacity-type
// [N, CT] planes before they cross to the host (solver/tpu.py:53-55):
//
//   out[r, j] = sum_b in[r, 8j + b] << (7 - b)   (most significant bit first,
//                                                 zero past the row's end)
//
// Bound on the H100: bytes.  At the main path's [8192, 1000] viable plane it
// reads 8 MB and writes 1 MB, about 3 us at 3.35 TB/s.  Design: one thread
// per output byte; neighbouring threads read neighbouring 8-byte groups, so
// the loads coalesce; a row's ragged tail masks its missing bits to zero.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void pack_bool_kernel(int64_t n_rows, int m, int out_cols,
                                 const uint8_t* __restrict__ in, uint8_t* __restrict__ out) {
  const int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (g >= n_rows * out_cols) return;
  const int64_t r = g / out_cols;
  const int j = static_cast<int>(g % out_cols);
  const uint8_t* row = in + r * m;
  unsigned int byte = 0;
  for (int b = 0; b < 8; ++b) {
    const int col = j * 8 + b;
    const unsigned int bit = (col < m && row[col]) ? 1u : 0u;
    byte |= bit << (7 - b);
  }
  out[g] = static_cast<uint8_t>(byte);
}

}  // namespace

extern "C" int kc_pack_bool(int64_t n_rows, int m, const void* in, void* out, void* stream) {
  const int out_cols = (m + 7) / 8;
  const int64_t total = n_rows * out_cols;
  if (total == 0) return 0;
  const int threads = 256;
  const int64_t blocks = (total + threads - 1) / threads;
  pack_bool_kernel<<<static_cast<unsigned int>(blocks), threads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      n_rows, m, out_cols, static_cast<const uint8_t*>(in), static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
