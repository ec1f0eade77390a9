// LayerNorm -> matmul: the pre-attention LN riding the qkv projection,
//   out = LN(x) . W^T + b,   x (R, D), W (F, D) torch Linear layout, out (R, F).
//
// Replaces the TPU kernel alpro_tpu/ops/pallas_ln_mlp.py::fused_ln_matmul
// (_ln_matmul_kernel). Contract kept from it: one-pass fp32 LN statistics
// (E[x^2] - E[x]^2, clamped at 0); the LN output rounds to W's dtype; the
// product accumulates in fp32; b is added in fp32; the output is in x's dtype.
//
// What bounds it on an H100: at the video tower's shape (R = 12 544 temporal
// or 12 608 spatial rows per 8 clips, D = 768, F = 2304) it is 44.5 GFLOP
// against 19 MB of x, 58 MB of output and 3.5 MB of weights, so the tensor
// cores bound it (0.045 ms). Design: the row-tile GEMM of row_tile.cuh. One
// block of 16 warps per 32 rows LNs its rows once (one warp per row) into a
// shared tile in W's dtype, then walks the F output columns in passes of 768
// (six 128-column groups, one 16x16 fp32 accumulator tile per warp and group
// in registers — all F = 2304 columns would not fit), each pass reading the
// weight in 128 x 128 tiles through shared memory, and writes each pass + b
// through a per-warp stage buffer. The row statistics are computed once per
// row tile, not once per pass. bf16 products run on the tensor cores (WMMA),
// fp32 on the CUDA cores (warp_tile.cuh).
#include "row_tile.cuh"

namespace {

using alpro::WarpTile;
using namespace alpro::rows;

constexpr int kCG = 6;  // 128-column output groups per pass

template <typename T>
size_t smem_bytes(int D) {
  return size_t(kTM) * (D + vec<T>()) * sizeof(T)            // LN'd row tile
         + size_t(kTile) * (kTile + vec<T>()) * sizeof(T)    // weight tile
         + size_t(kWarps) * 256 * 4;                          // per-warp stage
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
ln_matmul_kernel(const T* __restrict__ x, const float* __restrict__ ln_s,
                 const float* __restrict__ ln_b, const T* __restrict__ w,
                 const float* __restrict__ b, T* __restrict__ out, int R, int D, int F,
                 float eps) {
  const int r0 = blockIdx.x * kTM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ldx = D + vec<T>();

  extern __shared__ __align__(128) unsigned char smem[];
  T* xn = reinterpret_cast<T*>(smem);
  T* wt = xn + kTM * ldx;
  float* stage = reinterpret_cast<float*>(wt + kTile * (kTile + vec<T>())) + warp * 256;

  // ---- LN of the row tile, one warp per row; zero past R ----
  for (int r = warp; r < kTM; r += kWarps) {
    const int row = r0 + r;
    T* xr = xn + r * ldx;
    if (row >= R) {
      for (int c = lane; c < D; c += 32) xr[c] = alpro::from_f32<T>(0.0f);
      continue;
    }
    const T* src = x + long(row) * D;
    float s = 0.0f, ss = 0.0f;
    for (int c = lane; c < D; c += 32) {
      const float v = alpro::to_f32(src[c]);
      s += v;
      ss = fmaf(v, v, ss);
    }
    s = alpro::warp_sum(s);
    ss = alpro::warp_sum(ss);
    const float mean = s / D;
    const float var = fmaxf(ss / D - mean * mean, 0.0f);
    const float rstd = rsqrtf(var + eps);
    for (int c = lane; c < D; c += 32)
      xr[c] = alpro::from_f32<T>((alpro::to_f32(src[c]) - mean) * rstd * ln_s[c] + ln_b[c]);
  }

  // ---- passes of kCG output groups (gemm begins with a block sync) ----
  for (int c0 = 0; c0 < F; c0 += kCG * kTile) {
    WarpTile<T> acc[kCG];
#pragma unroll
    for (int g = 0; g < kCG; ++g) acc[g].zero();
    gemm<T, kCG, true>(acc, xn, ldx, w + long(c0) * D, D, D / kTile, wt);
    store_rows<T, kCG>(acc, stage, b, nullptr, out, F, c0, r0, R);
  }
}

template <typename T>
int launch(const void* x, const void* s, const void* bs, const void* w, const void* b, void* out,
           int R, int D, int F, float eps, cudaStream_t stream) {
  const size_t smem = smem_bytes<T>(D);
  cudaError_t err = cudaFuncSetAttribute(ln_matmul_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  ln_matmul_kernel<T><<<(R + kTM - 1) / kTM, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(s), static_cast<const float*>(bs),
      static_cast<const T*>(w), static_cast<const float*>(b), static_cast<T*>(out), R, D, F, eps);
  return int(cudaGetLastError());
}

}  // namespace

// x (R, D) and w (F, D) in one dtype, out (R, F) in it; ln_s, ln_b, b fp32.
// D % 128 == 0 (up to 1024), F % 768 == 0.
extern "C" int alpro_ln_matmul(const void* x, const void* ln_s, const void* ln_b, const void* w,
                               const void* b, void* out, int R, int D, int F, float eps,
                               int is_bf16, int device, void* stream) {
  constexpr int kTile = alpro::rows::kTile;
  if (R < 1 || D % kTile || D > 1024 || F % (kCG * kTile)) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(x, ln_s, ln_b, w, b, out, R, D, F, eps, st)
                 : launch<float>(x, ln_s, ln_b, w, b, out, R, D, F, eps, st);
}
