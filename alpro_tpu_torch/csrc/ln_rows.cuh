// The LN rows pass of the bf16 routes of K3 (csrc/ln_mlp.cu), B9, B10
// (csrc/fused_block.cu) and B11 (csrc/ln_matmul.cu): xn = bf16(LN(x)) over
// rows of D, one warp a row, the row in registers. One-pass fp32 statistics
// (E[x^2] - E[x]^2, clamped at 0), as alpro_tpu/ops/kernel_math.py::
// ln_rows_f32; the scale and shift are fp32, or (TV = bf16) the layer's bf16
// vectors widened on load, which is exact. launch_ln_linear puts the
// TMA/wgmma GEMM behind it: B11's whole bf16 route and B10's first two
// launches.
#pragma once

#include "gemm_wgmma.cuh"
#include "hopper.cuh"
#include "warp_tile.cuh"

namespace alpro {
namespace {

constexpr int kLnRows = 8;  // rows (warps) per block
constexpr int kLnVecs = 4;  // 8-element vectors a lane holds: D <= 1024

template <typename TV = float>
__global__ void __launch_bounds__(kLnRows * 32)
ln_rows(const __nv_bfloat16* __restrict__ x, const TV* __restrict__ ln_s,
        const TV* __restrict__ ln_b, __nv_bfloat16* __restrict__ xn, int R, int D, float eps) {
  const int row = blockIdx.x * kLnRows + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= R) return;
  const __nv_bfloat16* src = x + long(row) * D;
  float v[kLnVecs][8];
  float s = 0.0f, ss = 0.0f;
#pragma unroll
  for (int i = 0; i < kLnVecs; ++i) {
    const int c = (i * 32 + lane) * 8;
    if (c < D) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + c);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[i][2 * e] = __low2float(h[e]);
        v[i][2 * e + 1] = __high2float(h[e]);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        s += v[i][e];
        ss = fmaf(v[i][e], v[i][e], ss);
      }
    }
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float mean = s / D;
  const float var = fmaxf(ss / D - mean * mean, 0.0f);
  const float rstd = rsqrtf(var + eps);
#pragma unroll
  for (int i = 0; i < kLnVecs; ++i) {
    const int c = (i * 32 + lane) * 8;
    if (c < D) {
      uint4 o;
      uint32_t* ov = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = c + 2 * e;
        ov[e] = hopper::pack_bf16(
            (v[i][2 * e] - mean) * rstd * to_f32(ln_s[k]) + to_f32(ln_b[k]),
            (v[i][2 * e + 1] - mean) * rstd * to_f32(ln_s[k + 1]) + to_f32(ln_b[k + 1]));
      }
      *reinterpret_cast<uint4*>(xn + long(row) * D + c) = o;
    }
  }
}

// one ln_rows launch over R rows of D (D a multiple of 8, at most 1024)
template <typename TV>
int launch_ln_rows(const __nv_bfloat16* x, const TV* ln_s, const TV* ln_b, __nv_bfloat16* xn,
                   int R, int D, float eps, cudaStream_t stream) {
  if (R < 1 || D % 8 || D > 32 * 8 * kLnVecs) return int(cudaErrorInvalidValue);
  ln_rows<TV><<<(R + kLnRows - 1) / kLnRows, kLnRows * 32, 0, stream>>>(x, ln_s, ln_b, xn, R,
                                                                         D, eps);
  return int(cudaGetLastError());
}

// out (R, F) = bf16(LN(x) · wᵀ + b): the LN rows into the (R, D) bf16
// scratch xn, then gemm_wgmma.cuh's kRound over it (fp32 sums, + b in fp32,
// rounded once); w (F, D) bf16, b F values of TV. D a multiple of 64 up to
// 1024, F of 128 (checked before either launch).
template <typename TV>
int launch_ln_linear(const __nv_bfloat16* x, const TV* ln_s, const TV* ln_b,
                     const __nv_bfloat16* w, const TV* b, __nv_bfloat16* xn, __nv_bfloat16* out,
                     int R, int D, int F, float eps, cudaStream_t stream) {
  if (R < 1 || D < gemm::kBK || D % gemm::kBK || D > 32 * 8 * kLnVecs || F < gemm::kBN ||
      F % gemm::kBN)
    return int(cudaErrorInvalidValue);
  const int err = launch_ln_rows<TV>(x, ln_s, ln_b, xn, R, D, eps, stream);
  if (err) return err;
  return gemm::launch<gemm::kRound, TV>(xn, w, gemm::Epilogue{{out}, b, 0}, R, F, D, stream);
}

}  // namespace
}  // namespace alpro
