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
// cores bound it (0.045 ms).
//
// bf16: two launches behind the one C call (ln_rows.cuh's launch_ln_linear,
// which B10's bf16 route in csrc/fused_block.cu also runs):
//   1. ln_rows: xn = bf16(LN(x)) into an (R, D) bf16 scratch, one warp a
//      row;
//   2. gemm_wgmma.cuh's kRound: out = xn · Wᵀ + b with the fp32 accumulator
//      of the TMA/wgmma GEMM, b added in fp32, rounded once into out.
// The scratch round trip is 19 MB each way at the main shape (~0.012 ms at
// 3.35 TB/s). The LN and bias vectors are read in the layer's dtype (bf16,
// widened on load, or fp32). Limits: D a multiple of 64 up to 1024, F of
// 128, any R (rows past R are zero-filled by TMA and not stored).
//
// fp32 (a test dtype: no tensor-core product keeps fp32 operands): the
// row-tile GEMM of row_tile.cuh on the CUDA cores. One block of 16 warps per
// 32 rows LNs its rows once (one warp per row) into a shared tile, then
// walks the F output columns in passes of 768 (six 128-column groups, one
// 16x16 fp32 accumulator tile per warp and group in registers), each pass
// reading the weight in 128 x 128 tiles through shared memory, and writes
// each pass + b through a per-warp stage buffer. D % 128 == 0 up to 1024,
// F % 768 == 0.
#include "ln_rows.cuh"
#include "row_tile.cuh"

namespace {

using alpro::WarpTile;
using namespace alpro::rows;

constexpr int kCG = 6;  // 128-column output groups per pass
using T = float;        // the row-tile route is fp32's

size_t smem_bytes(int D) {
  return size_t(kTM) * (D + vec<T>()) * sizeof(T)            // LN'd row tile
         + size_t(kTile) * (kTile + vec<T>()) * sizeof(T)    // weight tile
         + size_t(kWarps) * 256 * 4;                          // per-warp stage
}

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

int launch_f32(const float* x, const float* s, const float* bs, const float* w, const float* b,
               float* out, int R, int D, int F, float eps, cudaStream_t stream) {
  if (D % kTile || D > 1024 || F % (kCG * kTile)) return int(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(ln_matmul_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  ln_matmul_kernel<<<(R + kTM - 1) / kTM, kThreads, smem, stream>>>(x, s, bs, w, b, out, R, D,
                                                                   F, eps);
  return int(cudaGetLastError());
}

}  // namespace

// x (R, D) and w (F, D) in one dtype, out (R, F) in it. bf16: ln_s, ln_b, b
// all bf16 (vec_bf16 1) or all fp32, xn an (R, D) bf16 scratch, D % 64 == 0
// up to 1024, F % 128 == 0. fp32: the vectors fp32, xn unused, D % 128 == 0
// up to 1024, F % 768 == 0.
extern "C" int alpro_ln_matmul(const void* x, const void* ln_s, const void* ln_b, const void* w,
                               const void* b, void* xn, void* out, int R, int D, int F, float eps,
                               int is_bf16, int vec_bf16, int device, void* stream) {
  if (R < 1 || (vec_bf16 && !is_bf16)) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  auto h = [](const void* p) { return static_cast<const bf16*>(p); };
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  if (!is_bf16)
    return launch_f32(f(x), f(ln_s), f(ln_b), f(w), f(b), static_cast<float*>(out), R, D, F,
                      eps, st);
  bf16* sc = static_cast<bf16*>(xn);
  bf16* o = static_cast<bf16*>(out);
  if (vec_bf16)
    return alpro::launch_ln_linear<bf16>(h(x), h(ln_s), h(ln_b), h(w), h(b), sc, o, R, D, F, eps,
                                         st);
  return alpro::launch_ln_linear<float>(h(x), f(ln_s), f(ln_b), h(w), f(b), sc, o, R, D, F, eps,
                                        st);
}
