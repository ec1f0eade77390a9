// The fp32 attention core of the spatial chains whose contract keeps q, k,
// v, the scores and p in fp32 (fused_block.cu's B9, qkv_proj.cu's B7): one
// warp owns 16 query rows of one head against the whole cell's K and V, all
// in fp32 in shared memory, and computes the exact softmax (row max first,
// then exp and sum) and p.V on the CUDA cores (warp_tile.cuh's fp32 tile).
#pragma once

#include "warp_tile.cuh"

namespace alpro {
namespace f32attn {

constexpr int kHD = 64;         // head dim
constexpr int kLdF = kHD + 4;   // leading dimension of the fp32 q/k/v rows

// per warp: 16 fp32 score rows (leading dimension SP + 4), a 16 x 16
// scratch and the 16 row sums
__host__ __device__ constexpr int warp_floats(int SP) { return 16 * (SP + 4) + 256 + 16; }

// One warp: the 16 query rows qs (fp32, already scaled, leading dimension
// kLdF) against the keys and values Ks, Vs (SP x kHD fp32, leading dimension
// kLdF, rows S.. zero). o / l is rounded to Out into row r of dst (dst + r *
// ldd) for r < nrows. wbuf: the warp's warp_floats(SP) floats. Warp-level
// syncs only.
template <typename Out>
__device__ __forceinline__ void attend16(const float* qs, const float* Ks, const float* Vs, int S,
                                         int SP, float* wbuf, Out* __restrict__ dst, long ldd,
                                         int nrows) {
  const int lane = threadIdx.x & 31;
  const int ldsc = SP + 4;
  float* sc = wbuf;
  float* scr = sc + 16 * ldsc;
  float* lrow = scr + 256;
  // ---- scores: (16 x 64) . (64 x SP), fp32 ----
  for (int j = 0; j < SP / 16; ++j) {
    WarpTile<float> acc;
    acc.zero();
#pragma unroll
    for (int kk = 0; kk < kHD; kk += 16)
      acc.template mma<true>(qs + kk, kLdF, Ks + j * 16 * kLdF + kk, kLdF);
    acc.store(sc + j * 16, ldsc);
  }
  __syncwarp();
  // ---- softmax per row: fp32 max, then p = exp(s - max) in place, l ----
  for (int r = 0; r < 16; ++r) {
    float* srow = sc + r * ldsc;
    float mx = -INFINITY;
    for (int c = lane; c < S; c += 32) mx = fmaxf(mx, srow[c]);
    mx = warp_max(mx);
    float l = 0.0f;
    for (int c = lane; c < SP; c += 32) {
      const float p = c < S ? expf(srow[c] - mx) : 0.0f;
      srow[c] = p;
      l += p;
    }
    l = warp_sum(l);
    if (lane == 0) lrow[r] = l;
  }
  __syncwarp();
  // ---- o = p . V: (16 x SP) . (SP x 64), fp32; o / l into dst ----
  WarpTile<float> o[kHD / 16];
#pragma unroll
  for (int n = 0; n < kHD / 16; ++n) o[n].zero();
  for (int j = 0; j < SP / 16; ++j)
#pragma unroll
    for (int n = 0; n < kHD / 16; ++n)
      o[n].template mma<false>(sc + j * 16, ldsc, Vs + j * 16 * kLdF + n * 16, kLdF);
#pragma unroll
  for (int n = 0; n < kHD / 16; ++n) {
    o[n].store(scr, 16);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = lane * 8 + i, r = e / 16, c = e % 16;
      if (r < nrows) dst[r * ldd + n * 16 + c] = from_f32<Out>(scr[e] / lrow[r]);
    }
    __syncwarp();
  }
}

}  // namespace f32attn
}  // namespace alpro
