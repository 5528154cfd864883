// K19: sampled spot interruptions, every replica's offering availability in
// one launch.
//
// Replaces `perturb_spot_availability` (karpenter_core_tpu/parallel/mesh.py:397)
// and `perturb_offering_availability` (:498), which draw
// `jax.random.uniform(PRNGKey(seed), (R, I, Z, CT))` and interrupt a cell
// where the draw falls below its threshold:
//
//   u[f]        = uniform of the flat row-major index f of (r, i, z, ct)
//   out[r,i,z,ct] = avail[i,z,ct] & ~(u < rate & is_spot[ct])   (mode 0)
//               = avail[i,z,ct] & ~(u < risk[i,z,ct])            (mode 1)
//
// The draw is JAX's partitionable threefry (relax/prng.py holds the host
// version): Threefry-2x32, 20 rounds, rotations (13,15,26,6)/(17,29,16,24),
// key parity 0x1BD11BDA, on the counter pair (f >> 32, f & 0xFFFFFFFF);
// the 32 bits are b1 ^ b2; the float is (bits >> 9 | 0x3F800000) read as
// f32, less 1.0 (exact: the result is a multiple of 2^-23 in [0, 1)).  The
// threshold is an f32 (the reference compares an f32 array with a Python
// float, which becomes the nearest f32).  A NaN risk interrupts nothing.
//
// Bound on the H100: operations.  At R = 1,024 replicas of I = 1,000 types,
// Z = 3 zones and CT = 2 capacity types (6.1M cells) it writes 6.1 MB
// (1.8 us at 3.35 TB/s) but computes one threefry a cell, about 100 32-bit
// integer operations: 0.6 G operations, 9 us at 67 T/s.
// Design: one thread per output cell in a grid-stride loop over a 64-bit
// flat index; no bits buffer comes from the host.  The key words and the
// threshold are kernel arguments.  Neighbouring threads write neighbouring
// bytes, so the stores coalesce.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) {
  return (x << d) | (x >> (32 - d));
}

__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1, uint32_t hi,
                                                  uint32_t lo) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t x0 = hi + ks[0];
  uint32_t x1 = lo + ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  return x0 ^ x1;
}

__global__ void __launch_bounds__(kThreads) perturb_avail_kernel(
    long long n_total, long long n_cells, int n_ct, uint32_t k0, uint32_t k1, int mode,
    float rate,
    const uint8_t* __restrict__ avail,    // [I, Z, CT]
    const uint8_t* __restrict__ is_spot,  // [CT] (mode 0)
    const float* __restrict__ risk,       // [I, Z, CT] (mode 1)
    uint8_t* __restrict__ out) {          // [R, I, Z, CT]
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long f = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       f < n_total; f += stride) {
    const unsigned long long uf = static_cast<unsigned long long>(f);
    const uint32_t bits = threefry_bits(k0, k1, static_cast<uint32_t>(uf >> 32),
                                        static_cast<uint32_t>(uf & 0xFFFFFFFFull));
    const float u = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
    const long long cell = f % n_cells;
    bool hit;
    if (mode == 0) {
      hit = (u < rate) && is_spot[cell % n_ct];
    } else {
      hit = u < risk[cell];
    }
    out[f] = (avail[cell] && !hit) ? 1 : 0;
  }
}

}  // namespace

extern "C" int kc_perturb_avail(
    long long n_replicas, long long n_cells, int n_ct, unsigned int k0, unsigned int k1,
    int mode, float rate, const void* avail, const void* is_spot, const void* risk, void* out,
    void* stream) {
  const long long n_total = n_replicas * n_cells;
  if (n_total <= 0) return 0;
  if (mode != 0 && mode != 1) return static_cast<int>(cudaErrorInvalidValue);
  long long blocks = (n_total + kThreads - 1) / kThreads;
  if (blocks > 132LL * 64) blocks = 132LL * 64;
  perturb_avail_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      n_total, n_cells, n_ct, k0, k1, mode, rate, static_cast<const uint8_t*>(avail),
      static_cast<const uint8_t*>(is_spot), static_cast<const float*>(risk),
      static_cast<uint8_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
