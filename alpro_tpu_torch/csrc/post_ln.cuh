// The post-LN finalize pass of the BERT kernels K5 (csrc/ln_mlp.cu) and K4
// (csrc/bert_attn.cu): out = LN(sum of the split-K partials + bias + x) over
// rows of D. The partials are summed in slice order, so repeated calls are
// bit-equal; the bias and the residual x are added in fp32; the LN takes
// one-pass fp32 statistics (E[y^2] - E[y]^2, clamped at 0) and rounds once.
// One block a row, the row in registers (D <= kFinThreads * kFinMaxPer). The
// bias and the LN scale and shift are fp32, or (TV = bf16, K4) the layer's
// bf16 vectors widened on load, which is exact.
#pragma once

#include "warp_tile.cuh"

namespace alpro {
namespace {

constexpr int kFinThreads = 256;
constexpr int kFinMaxPer = 4;  // D <= 1024

template <typename T, typename TV = float>
__global__ void __launch_bounds__(kFinThreads)
bert_mlp_finalize(const float* __restrict__ partial, int splits, const TV* __restrict__ b2,
                  const T* __restrict__ x, const TV* __restrict__ ln_s,
                  const TV* __restrict__ ln_b, T* __restrict__ out, int R, int D, float eps) {
  __shared__ float red[2][kFinThreads / 32];
  const int row = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long n = long(R) * D, base = long(row) * D;
  float y[kFinMaxPer];
  float s = 0.0f, ss = 0.0f;
#pragma unroll
  for (int j = 0; j < kFinMaxPer; ++j) {
    const int c = threadIdx.x + j * kFinThreads;
    y[j] = 0.0f;
    if (c < D) {
      float v = 0.0f;
      for (int k = 0; k < splits; ++k) v += partial[k * n + base + c];
      v += to_f32(b2[c]) + to_f32(x[base + c]);
      y[j] = v;
      s += v;
      ss = fmaf(v, v, ss);
    }
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  if (lane == 0) {
    red[0][warp] = s;
    red[1][warp] = ss;
  }
  __syncthreads();
  s = ss = 0.0f;
#pragma unroll
  for (int w = 0; w < kFinThreads / 32; ++w) {
    s += red[0][w];
    ss += red[1][w];
  }
  const float mean = s / D;
  const float var = fmaxf(ss / D - mean * mean, 0.0f);
  const float rstd = rsqrtf(var + eps);
#pragma unroll
  for (int j = 0; j < kFinMaxPer; ++j) {
    const int c = threadIdx.x + j * kFinThreads;
    if (c < D)
      out[base + c] = from_f32<T>((y[j] - mean) * rstd * to_f32(ln_s[c]) + to_f32(ln_b[c]));
  }
}

}  // namespace
}  // namespace alpro
