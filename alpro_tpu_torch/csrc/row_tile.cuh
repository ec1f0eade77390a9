// Shared pieces of the row-tile kernels (ln_mlp.cu, bert_attn.cu's
// projection + LN pass, ln_matmul.cu, patchify_embed.cu, the projection
// launch proj_rows of fused_block.cu and qkv_proj.cu, qkv_proj.cu's
// temporal chain): a block of kWarps warps owns kTM whole rows across
// all D output columns, with one fp32 16x16 accumulator tile per warp in
// every 128-column group held in registers; weight tiles of 128 x 128 are
// read from device memory with coalesced 16-byte loads into registers,
// stored to shared memory, and multiplied by every warp.
#pragma once

#include <algorithm>

#include "warp_tile.cuh"

namespace alpro {
namespace rows {

constexpr int kTM = 32;     // rows per block
constexpr int kTile = 128;  // weight tile edge = output group width
constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
static_assert((kTM / 16) * (kTile / 16) == kWarps, "one 16x16 tile per warp");

// elements per 16 bytes: the vector width of the tile loads, and the padding
// of every shared-memory row (against bank conflicts)
template <typename T> __host__ __device__ constexpr int vec() { return 16 / int(sizeof(T)); }
// 16-byte vectors of one 128 x 128 weight tile per thread
template <typename T> __host__ __device__ constexpr int tile_vecs() {
  return kTile * kTile / vec<T>() / kThreads;
}
// leading dimension of the fp32 (kTM x D) row buffer of the post-LN epilogue
__host__ __device__ constexpr int ybuf_ld(int D) { return D + 8; }
inline size_t ybuf_bytes(int D) { return size_t(kTM) * ybuf_ld(D) * 4; }

// the 128 x 128 tile at src (row stride `stride` elements) into registers
template <typename T>
__device__ __forceinline__ void load_tile(uint4 (&buf)[tile_vecs<T>()], const T* src,
                                          int stride) {
  constexpr int vpr = kTile / vec<T>();  // vectors per tile row
#pragma unroll
  for (int i = 0; i < tile_vecs<T>(); ++i) {
    const int idx = threadIdx.x + i * kThreads, r = idx / vpr, c = idx % vpr;
    buf[i] = reinterpret_cast<const uint4*>(src + long(r) * stride)[c];
  }
}

// registers -> shared tile wt (leading dimension kTile + vec<T>())
template <typename T>
__device__ __forceinline__ void store_tile(const uint4 (&buf)[tile_vecs<T>()], T* wt) {
  constexpr int vpr = kTile / vec<T>(), ld = kTile + vec<T>();
#pragma unroll
  for (int i = 0; i < tile_vecs<T>(); ++i) {
    const int idx = threadIdx.x + i * kThreads, r = idx / vpr, c = idx % vpr;
    reinterpret_cast<uint4*>(wt + r * ld)[c] = buf[i];
  }
}

// acc[g] (this warp's 16x16 tile in output group g, columns 128 g + 16 tc..)
// += A[16 tr.., 0..K) . B[0..K), 128 g..) over KT = K / 128 k-tiles, with A
// the block's kTM x K tile in shared memory (leading dimension lda) and B
// read in 128 x 128 tiles through the shared tile wt: a torch Linear weight
// (out, in) when kOutIn, B(k, n) = w[n * ldw + k]; else row-major (in, out),
// B(k, n) = w[k * ldw + n]. w points at output column 0 of group 0. The next
// tile is loaded into registers while the current one is multiplied. Every
// thread of the block calls it; it begins and ends with a block sync.
template <typename T, int NG, bool kOutIn>
__device__ __forceinline__ void gemm(WarpTile<T> (&acc)[NG], const T* a, int lda,
                                     const T* __restrict__ w, int ldw, int KT, T* wt) {
  constexpr int ldt = kTile + vec<T>();
  const int warp = threadIdx.x >> 5;
  const int tr = warp / (kTile / 16), tc = warp % (kTile / 16);
  auto tile = [&](int g, int kt) {
    return kOutIn ? w + long(g) * kTile * ldw + kt * kTile : w + long(kt) * kTile * ldw + g * kTile;
  };
  uint4 buf[tile_vecs<T>()];
  load_tile<T>(buf, tile(0, 0), ldw);
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    for (int kt = 0; kt < KT; ++kt) {
      __syncthreads();  // every warp is done with the previous tile (and A is staged)
      store_tile<T>(buf, wt);
      __syncthreads();
      if (kt + 1 < KT)
        load_tile<T>(buf, tile(g, kt + 1), ldw);
      else if (g + 1 < NG)
        load_tile<T>(buf, tile(g + 1, 0), ldw);
      const T* ar = a + tr * 16 * lda + kt * kTile;
#pragma unroll
      for (int kk = 0; kk < kTile; kk += 16) {
        if constexpr (kOutIn)
          acc[g].template mma<true>(ar + kk, lda, wt + tc * 16 * ldt + kk, ldt);
        else
          acc[g].template mma<false>(ar + kk, lda, wt + kk * ldt + tc * 16, ldt);
      }
    }
  }
  __syncthreads();
}

// out[r0 + r, col0 + c] = acc + bias[col0 + c] (+ residual at the same place)
// in fp32, rounded to T, for the rows below R; ld is the row stride of out
// and residual. One 16x16 tile at a time through the warp's 256-float stage
// buffer (32-byte aligned).
template <typename T, int NG>
__device__ __forceinline__ void store_rows(WarpTile<T> (&acc)[NG], float* stage,
                                           const float* __restrict__ bias,
                                           const T* __restrict__ residual, T* __restrict__ out,
                                           int ld, int col0, int r0, int R) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tr = warp / (kTile / 16), tc = warp % (kTile / 16);
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    acc[g].store(stage, 16);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int e = lane * 8 + j, row = r0 + tr * 16 + e / 16;
      const int col = col0 + g * kTile + tc * 16 + e % 16;
      if (row < R) {
        float y = stage[e] + bias[col];
        if (residual != nullptr) y += to_f32(residual[long(row) * ld + col]);
        out[long(row) * ld + col] = from_f32<T>(y);
      }
    }
    __syncwarp();
  }
}

// Post-LN epilogue: out[r0 + r] = LN(acc + bias + x), fp32 residual and
// one-pass fp32 statistics (E[y^2] - E[y]^2, clamped at 0), for the block's
// kTM rows. ybuf: fp32 (kTM x ybuf_ld(D)) shared memory that nothing else
// uses any more (the caller syncs the block before). Ends with the block
// synced.
template <typename T, int NG>
__device__ __forceinline__ void post_ln_epilogue(WarpTile<T> (&acc)[NG], float* ybuf,
                                                 const float* __restrict__ bias,
                                                 const T* __restrict__ x,
                                                 const float* __restrict__ ln_s,
                                                 const float* __restrict__ ln_b,
                                                 T* __restrict__ out, int r0, int R,
                                                 float eps) {
  constexpr int D = NG * kTile, ld = ybuf_ld(D);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tr = warp / (kTile / 16), tc = warp % (kTile / 16);
#pragma unroll
  for (int g = 0; g < NG; ++g) acc[g].store(ybuf + tr * 16 * ld + g * kTile + tc * 16, ld);
  __syncthreads();
  for (int r = warp; r < kTM; r += kWarps) {
    const int row = r0 + r;
    if (row >= R) continue;
    float* yr = ybuf + r * ld;
    const T* xr = x + long(row) * D;
    float s = 0.0f, ss = 0.0f;
    for (int c = lane; c < D; c += 32) {
      const float v = yr[c] + bias[c] + to_f32(xr[c]);
      yr[c] = v;
      s += v;
      ss = fmaf(v, v, ss);
    }
    s = warp_sum(s);
    ss = warp_sum(ss);
    const float mean = s / D;
    const float var = fmaxf(ss / D - mean * mean, 0.0f);
    const float rstd = rsqrtf(var + eps);
    T* orow = out + long(row) * D;
    for (int c = lane; c < D; c += 32)
      orow[c] = from_f32<T>((yr[c] - mean) * rstd * ln_s[c] + ln_b[c]);
  }
  __syncthreads();
}

// ---- the projection launch of the two-launch chains (fused_block.cu,
//      qkv_proj.cu): out = heads . W^T + bias (+ residual), heads (R, D)
//      in T, W in torch Linear layout (D, D), bias fp32 ----

template <typename T, int NG>
__global__ void __launch_bounds__(kThreads, 1)
proj_rows(const T* __restrict__ heads, const T* __restrict__ w, const float* __restrict__ bias,
          const T* __restrict__ residual, T* __restrict__ out, int R) {
  constexpr int D = NG * kTile, ldo = D + vec<T>();
  const int r0 = blockIdx.x * kTM;
  const int warp = threadIdx.x >> 5;

  extern __shared__ __align__(128) unsigned char smem[];
  T* ot = reinterpret_cast<T*>(smem);
  T* wt = ot + kTM * ldo;
  float* stage = reinterpret_cast<float*>(wt + kTile * (kTile + vec<T>())) + warp * 256;

  constexpr int vpr = D / vec<T>();
  for (int i = threadIdx.x; i < kTM * vpr; i += kThreads) {
    const int r = i / vpr, c = i % vpr;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + r < R) v = reinterpret_cast<const uint4*>(heads + long(r0 + r) * D)[c];
    reinterpret_cast<uint4*>(ot + r * ldo)[c] = v;
  }
  WarpTile<T> acc[NG];
#pragma unroll
  for (int g = 0; g < NG; ++g) acc[g].zero();
  gemm<T, NG, true>(acc, ot, ldo, w, D, NG, wt);  // begins with a block sync
  store_rows<T, NG>(acc, stage, bias, residual, out, D, 0, r0, R);
}

template <typename T, int NG>
int launch_proj(const void* heads, const void* w, const void* bias, const void* residual,
                void* out, int R, cudaStream_t stream) {
  constexpr int D = NG * kTile;
  const size_t smem = size_t(kTM) * (D + vec<T>()) * sizeof(T) +
                      size_t(kTile) * (kTile + vec<T>()) * sizeof(T) + size_t(kWarps) * 256 * 4;
  cudaError_t err = cudaFuncSetAttribute(proj_rows<T, NG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  proj_rows<T, NG><<<(R + kTM - 1) / kTM, kThreads, smem, stream>>>(
      static_cast<const T*>(heads), static_cast<const T*>(w), static_cast<const float*>(bias),
      static_cast<const T*>(residual), static_cast<T*>(out), R);
  return int(cudaGetLastError());
}

// the projection launch for D in (256, 512, 768, 1024)
template <typename T>
int dispatch_proj(int D, const void* heads, const void* w, const void* bias, const void* residual,
                  void* out, int R, cudaStream_t st) {
  switch (D) {
#define ALPRO_PROJ_CASE(NG) \
  case NG * kTile: return launch_proj<T, NG>(heads, w, bias, residual, out, R, st);
    ALPRO_PROJ_CASE(2)
    ALPRO_PROJ_CASE(4)
    ALPRO_PROJ_CASE(6)
    ALPRO_PROJ_CASE(8)
#undef ALPRO_PROJ_CASE
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace rows
}  // namespace alpro
