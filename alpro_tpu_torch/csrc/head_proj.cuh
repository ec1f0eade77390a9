// The per-head q/k/v projection of the heads launches that compute q, k and
// v themselves (fused_block.cu's B9 and B10, block_attn.cu's B17): a block of
// kWarps warps projects kRC rows of x through one head's 64-row weight slices
// in 64 x 64 chunks staged in shared memory, with WMMA bf16 / fp32 CUDA-core
// tiles (warp_tile.cuh), fp32 accumulators in registers; store_biased adds
// the fp32 bias and writes a warp's 16 rows out.
#pragma once

#include "warp_tile.cuh"

namespace alpro {
namespace heads {

constexpr int kHD = 64;     // head dim
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kKC = 64;     // depth chunk of the projections
constexpr int kRC = 64;     // rows per projection step, 16 per warp

template <typename T> __host__ __device__ constexpr int pad() { return 16 / int(sizeof(T)); }
template <typename T> __host__ __device__ constexpr int ldc() { return kKC + pad<T>(); }
// the staging area of project<T, nw, ..>: the x chunk and nw weight chunks
template <typename T> __host__ __device__ constexpr size_t staging_bytes(int nw) {
  return size_t(kRC + nw * kHD) * ldc<T>() * sizeof(T);
}

// Project kRC rows (g0..; a null row pointer is a zero row) through NW
// 64-row weight slices w[i] (torch layout, row stride D). With kLN the LN
// (mean, rstd per row, fp32 ln_s, ln_b per column) is applied while each
// 64 x 64 chunk of x is staged, rounded to T; without it x is staged as it
// is (mean, rstd, ln_s, ln_b unused). Warp w accumulates rows 16w.. into
// acc[i][0..4) when active. Every load of a chunk is a 16-byte vector, and a
// thread issues all of its x loads before it uses any, so a chunk costs
// about one trip to L2. Begins and ends with a block sync.
template <typename T, int NW, bool kLN, typename RowFn>
__device__ __forceinline__ void project(RowFn row_ptr, int g0, const float* mean,
                                        const float* rstd, const float* __restrict__ ln_s,
                                        const float* __restrict__ ln_b, int D,
                                        const T* const (&w)[NW], T* stage,
                                        WarpTile<T> (&acc)[NW][kHD / 16], bool active) {
  constexpr int ld = ldc<T>(), vx = 16 / int(sizeof(T)), vpr = kKC / vx;
  constexpr int x_vecs = kRC * vpr / kThreads, w_vecs = kHD * vpr / kThreads;
  const int warp = threadIdx.x >> 5;
  T* xs = stage;
  T* ws = xs + kRC * ld;
#pragma unroll
  for (int i = 0; i < NW; ++i)
#pragma unroll
    for (int n = 0; n < kHD / 16; ++n) acc[i][n].zero();
  for (int kc = 0; kc < D; kc += kKC) {
    __syncthreads();  // every warp is done with the previous chunk (and the statistics)
    uint4 xv[x_vecs];
#pragma unroll
    for (int i = 0; i < x_vecs; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const T* src = row_ptr(g0 + e / vpr);
      xv[i] = src != nullptr ? reinterpret_cast<const uint4*>(src + kc)[e % vpr]
                             : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int i = 0; i < NW; ++i)
#pragma unroll
      for (int j = 0; j < w_vecs; ++j) {
        const int e = threadIdx.x + j * kThreads, r = e / vpr, c = e % vpr;
        reinterpret_cast<uint4*>(ws + (i * kHD + r) * ld)[c] =
            reinterpret_cast<const uint4*>(w[i] + long(r) * D + kc)[c];
      }
#pragma unroll
    for (int i = 0; i < x_vecs; ++i) {
      const int e = threadIdx.x + i * kThreads, r = e / vpr, c = (e % vpr) * vx;
      if constexpr (kLN) {
        const bool valid = row_ptr(g0 + r) != nullptr;
        const T* v = reinterpret_cast<const T*>(&xv[i]);
        alignas(16) T out[vx];
#pragma unroll
        for (int q = 0; q < vx; ++q) {
          const int col = kc + c + q;
          out[q] = from_f32<T>(
              valid ? (to_f32(v[q]) - mean[g0 + r]) * rstd[g0 + r] * ln_s[col] + ln_b[col]
                    : 0.0f);
        }
        *reinterpret_cast<uint4*>(xs + r * ld + c) = *reinterpret_cast<const uint4*>(out);
      } else {
        *reinterpret_cast<uint4*>(xs + r * ld + c) = xv[i];
      }
    }
    __syncthreads();
    if (!active) continue;
#pragma unroll
    for (int kk = 0; kk < kKC; kk += 16)
#pragma unroll
      for (int i = 0; i < NW; ++i)
#pragma unroll
        for (int n = 0; n < kHD / 16; ++n)
          acc[i][n].template mma<true>(xs + warp * 16 * ld + kk, ld,
                                       ws + (i * kHD + n * 16) * ld + kk, ld);
  }
  __syncthreads();  // the staging buffer is free again
}

// (acc + bias[0..64)) * mul in fp32 into 16 rows of dst (leading dimension
// ldd), converted to Out, through the warp's 256-float scratch
template <typename Out, typename T>
__device__ __forceinline__ void store_biased(WarpTile<T> (&acc)[kHD / 16], float* scr,
                                             const float* __restrict__ bias, Out* dst, int ldd,
                                             float mul) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < kHD / 16; ++n) {
    acc[n].store(scr, 16);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int e = lane * 8 + j, r = e / 16, c = e % 16;
      dst[r * ldd + n * 16 + c] = from_f32<Out>((scr[e] + bias[n * 16 + c]) * mul);
    }
    __syncwarp();
  }
}

}  // namespace heads
}  // namespace alpro
