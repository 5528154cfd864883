// K10: the warm repair's eviction free.
//
// Replaces `_repair_free_impl` (karpenter_core_tpu/ops/solve.py:1960): the
// pods evicted since the carry was taken give back their capacity, pod
// counts and topology-group counts, on the new slots and on the existing
// nodes.  For every column n of either side (a new slot or an existing
// node), with free[c, n] the pods of class c evicted from it:
//
//   used[n, r]   -= sum_c free[c, n] * req[c, r]
//   pod_count[n]  = max(pod_count[n] - sum_c free[c, n], 0)
//   fwd[g, n]     = max(fwd[g, n] - sum_c member[c, g] * free[c, n], 0)
//   inv[g, n]     = max(inv[g, n] - sum_c own_inv[c, g] * free[c, n], 0)
//
// Requirement masks, zone and capacity-type commitments, ports and volume
// counters are not reverted (the reference's one-way pessimism).
//
// Bound on the H100: bytes.  At the headline tick (C = 16, N = 8,192,
// R = 3, G1 = 8, E = 1) it reads the two free planes (0.5 MB), the carry's
// used, pod counts and four topology planes and writes the same planes:
// about 1.3 MB, 0.4 us at 3.35 TB/s, far below a launch's latency, which is
// what bounds it in practice.
// Design: ONE launch.  A block of 32 x Y threads (Y = min(outputs, 8))
// takes 32 consecutive columns of one side (the new slots' blocks first,
// then the existing nodes'), so the headline's 8,193 columns make 257
// blocks of 256 threads, two an SM.  A column has R + 1 + 2 * G1 outputs
// (its R used entries, its pod count, its G1 fwd and G1 inv counts); they
// are split across threadIdx.y, each thread accumulating up to 4 of them in
// registers, so the column's work no longer runs as one thread's chain of
// (R + 1 + G1) * C dependent loads.  How each byte is read:
//  - free_: a chunk of 16 classes x 32 columns is staged in shared memory,
//    each element loaded once from device memory (coalesced along the
//    columns), and read there by every thread of its column;
//  - req, member and own_inv: the chunk's coefficients of the block's
//    outputs are staged beside it, once a block at the headline (C = 16 is
//    one chunk and 20 outputs one batch); more classes loop over chunks,
//    more outputs over batches of 32;
//  - used, pod_count, fwd, inv: each element is loaded by the one thread
//    that owns it, before the class loop (so its latency overlaps the
//    staging), and written by that thread after it.
//
// Arithmetic matches the reference and the plain twin bit for bit: the f32
// sum is XLA's CPU dot behind the reference's einsum, from 0, one fused
// multiply-add a class, classes ascending (`__fmaf_rn`), then `__fsub_rn`
// from the usage.  int32 sums wrap as the reference's do (unsigned
// arithmetic), in any order.
//
// K21, `kc_repair_free_inplace`, replaces `repair_free_donated` (ops/solve.py:
// 2012, the same body with the carry donated): the same kernel with each
// output pointer equal to its input pointer, so the carry's used, pod_count,
// fwd_* and inv_* planes are freed where they lie and no full-width plane is
// allocated.  That aliasing is legal because each element is read and then
// written by one thread only, and because no pointer of `Side` carries
// `__restrict__`: keep it so.  `req`, `member` and `own_inv` are restrict
// and are never carry planes.  Same bytes, same bound, same order of the
// f32 sum as K10.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;   // columns a block (threadIdx.x)
constexpr int kRows = 8;    // most threads a column (threadIdx.y)
constexpr int kOwn = 4;     // outputs a thread accumulates at a time
constexpr int kChunk = 16;  // classes staged at a time
constexpr int kBatch = kRows * kOwn;  // outputs of a column staged at a time

// No member is `__restrict__`: K21 passes each output equal to its input.
struct Side {
  int cols;
  const int32_t* free_;       // [C, cols]
  const float* used;          // [cols, R]
  const int32_t* pod_count;   // [cols]
  const int32_t* fwd;         // [G1, cols]
  const int32_t* inv;         // [G1, cols]
  float* used_out;
  int32_t* pod_count_out;
  int32_t* fwd_out;
  int32_t* inv_out;
};

__device__ __forceinline__ int32_t sub_floor0(int32_t a, uint32_t b) {
  const int32_t d = static_cast<int32_t>(static_cast<uint32_t>(a) - b);
  return d > 0 ? d : 0;
}

// Output o of a column: o < R is used[., o]; o == R the pod count; then the
// G1 fwd groups and the G1 inv groups.  The coefficient of class c in it.
__device__ __forceinline__ uint32_t coefficient(int o, int c, int n_res, int g1,
                                                const float* __restrict__ req,
                                                const int32_t* __restrict__ member,
                                                const int32_t* __restrict__ own_inv) {
  if (o < n_res) return __float_as_uint(req[c * n_res + o]);
  if (o == n_res) return 1u;
  const int g = o - n_res - 1;
  if (g < g1) return static_cast<uint32_t>(member[c * g1 + g]);
  return static_cast<uint32_t>(own_inv[c * g1 + g - g1]);
}

__global__ void __launch_bounds__(kCols * kRows) repair_free_kernel(
    int n_cls, int n_res, int g1, int blocks_new, const float* __restrict__ req,
    const int32_t* __restrict__ member, const int32_t* __restrict__ own_inv,
    Side new_side, Side ex_side) {
  __shared__ uint32_t free_s[kChunk][kCols];
  __shared__ uint32_t coef_s[kChunk][kBatch];
  const bool is_new = static_cast<int>(blockIdx.x) < blocks_new;
  const Side s = is_new ? new_side : ex_side;
  const int col0 = (is_new ? blockIdx.x : blockIdx.x - blocks_new) * kCols;
  const int x = threadIdx.x, y = threadIdx.y, rows = blockDim.y;
  const int tid = y * kCols + x, n_threads = kCols * rows;
  const int j = col0 + x;
  const bool live = j < s.cols;
  const int cols = s.cols;
  const int n_out = n_res + 1 + 2 * g1;

  for (int o0 = 0; o0 < n_out; o0 += rows * kOwn) {
    const int nb = min(rows * kOwn, n_out - o0);
    // the owned outputs' old values, loaded before the class loop
    uint32_t old[kOwn];
    float accf[kOwn];
    uint32_t acci[kOwn];
#pragma unroll
    for (int q = 0; q < kOwn; ++q) {
      const int o = o0 + q * rows + y;
      old[q] = 0u;
      accf[q] = 0.0f;
      acci[q] = 0u;
      if (!live || q * rows + y >= nb) continue;
      if (o < n_res) {
        old[q] = __float_as_uint(s.used[static_cast<size_t>(j) * n_res + o]);
      } else if (o == n_res) {
        old[q] = static_cast<uint32_t>(s.pod_count[j]);
      } else if (o - n_res - 1 < g1) {
        old[q] = static_cast<uint32_t>(s.fwd[static_cast<size_t>(o - n_res - 1) * cols + j]);
      } else {
        old[q] = static_cast<uint32_t>(
            s.inv[static_cast<size_t>(o - n_res - 1 - g1) * cols + j]);
      }
    }
    for (int c0 = 0; c0 < n_cls; c0 += kChunk) {
      const int nc = min(kChunk, n_cls - c0);
      __syncthreads();  // the previous chunk's readers are done
      for (int i = tid; i < kChunk * kCols; i += n_threads) {
        const int cc = i / kCols, xx = i % kCols;
        const int jj = col0 + xx;
        free_s[cc][xx] = (cc < nc && jj < cols)
            ? static_cast<uint32_t>(s.free_[static_cast<size_t>(c0 + cc) * cols + jj]) : 0u;
      }
      for (int i = tid; i < nc * nb; i += n_threads) {
        const int cc = i / nb, ob = i % nb;
        coef_s[cc][ob] = coefficient(o0 + ob, c0 + cc, n_res, g1, req, member, own_inv);
      }
      __syncthreads();
#pragma unroll
      for (int q = 0; q < kOwn; ++q) {
        const int ob = q * rows + y;  // the same for the whole warp
        if (ob >= nb) continue;
        if (o0 + ob < n_res) {
          // from 0, one fused multiply-add a class, classes ascending
          float sum = accf[q];
          for (int cc = 0; cc < nc; ++cc) {
            const float f = static_cast<float>(static_cast<int32_t>(free_s[cc][x]));
            sum = __fmaf_rn(f, __uint_as_float(coef_s[cc][ob]), sum);
          }
          accf[q] = sum;
        } else {
          uint32_t sum = acci[q];
          for (int cc = 0; cc < nc; ++cc) sum += coef_s[cc][ob] * free_s[cc][x];
          acci[q] = sum;
        }
      }
    }
    if (!live) continue;
#pragma unroll
    for (int q = 0; q < kOwn; ++q) {
      const int o = o0 + q * rows + y;
      if (q * rows + y >= nb) continue;
      if (o < n_res) {
        s.used_out[static_cast<size_t>(j) * n_res + o] =
            __fsub_rn(__uint_as_float(old[q]), accf[q]);
      } else if (o == n_res) {
        s.pod_count_out[j] = sub_floor0(static_cast<int32_t>(old[q]), acci[q]);
      } else if (o - n_res - 1 < g1) {
        s.fwd_out[static_cast<size_t>(o - n_res - 1) * cols + j] =
            sub_floor0(static_cast<int32_t>(old[q]), acci[q]);
      } else {
        s.inv_out[static_cast<size_t>(o - n_res - 1 - g1) * cols + j] =
            sub_floor0(static_cast<int32_t>(old[q]), acci[q]);
      }
    }
  }
}

}  // namespace

extern "C" int kc_repair_free(
    int n_new, int n_ex, int n_cls, int n_res, int g1, const void* req, const void* member,
    const void* own_inv, const void* free_new, const void* used_new, const void* pod_count_new,
    const void* fwd_new, const void* inv_new, const void* free_ex, const void* used_ex,
    const void* pod_count_ex, const void* fwd_ex, const void* inv_ex, void* used_new_out,
    void* pod_count_new_out, void* fwd_new_out, void* inv_new_out, void* used_ex_out,
    void* pod_count_ex_out, void* fwd_ex_out, void* inv_ex_out, void* stream) {
  const int total = n_new + n_ex;
  if (total <= 0) return 0;
  const Side new_side{n_new,
                      static_cast<const int32_t*>(free_new),
                      static_cast<const float*>(used_new),
                      static_cast<const int32_t*>(pod_count_new),
                      static_cast<const int32_t*>(fwd_new),
                      static_cast<const int32_t*>(inv_new),
                      static_cast<float*>(used_new_out),
                      static_cast<int32_t*>(pod_count_new_out),
                      static_cast<int32_t*>(fwd_new_out),
                      static_cast<int32_t*>(inv_new_out)};
  const Side ex_side{n_ex,
                     static_cast<const int32_t*>(free_ex),
                     static_cast<const float*>(used_ex),
                     static_cast<const int32_t*>(pod_count_ex),
                     static_cast<const int32_t*>(fwd_ex),
                     static_cast<const int32_t*>(inv_ex),
                     static_cast<float*>(used_ex_out),
                     static_cast<int32_t*>(pod_count_ex_out),
                     static_cast<int32_t*>(fwd_ex_out),
                     static_cast<int32_t*>(inv_ex_out)};
  const int blocks_new = (n_new + kCols - 1) / kCols;
  const int blocks = blocks_new + (n_ex + kCols - 1) / kCols;
  const int n_out = n_res + 1 + 2 * g1;
  const dim3 block(kCols, n_out < kRows ? n_out : kRows);
  repair_free_kernel<<<blocks, block, 0, static_cast<cudaStream_t>(stream)>>>(
      n_cls, n_res, g1, blocks_new, static_cast<const float*>(req),
      static_cast<const int32_t*>(member), static_cast<const int32_t*>(own_inv), new_side,
      ex_side);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int kc_repair_free_inplace(
    int n_new, int n_ex, int n_cls, int n_res, int g1, const void* req, const void* member,
    const void* own_inv, const void* free_new, void* used_new, void* pod_count_new,
    void* fwd_new, void* inv_new, const void* free_ex, void* used_ex, void* pod_count_ex,
    void* fwd_ex, void* inv_ex, void* stream) {
  return kc_repair_free(n_new, n_ex, n_cls, n_res, g1, req, member, own_inv, free_new,
                        used_new, pod_count_new, fwd_new, inv_new, free_ex, used_ex,
                        pod_count_ex, fwd_ex, inv_ex, used_new, pod_count_new, fwd_new,
                        inv_new, used_ex, pod_count_ex, fwd_ex, inv_ex, stream);
}
