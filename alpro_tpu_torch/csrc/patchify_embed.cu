// Raw uint8 frames -> embedded patch tokens:
//   out[f, n] = sum_k norm(patch(f, n))[k] * kernel[k] + bias,
//   raw (frames, H, W, 3) uint8, kernel (p*p*3, D) with rows in (ph, pw, c)
//   order, out (frames, N, D), N = (H / p) * (W / p).
//
// Replaces the TPU kernel alpro_tpu/ops/pallas_preprocess.py::
// fused_patchify_embed (_kernel, with the XLA normalize in front of it).
// Contract kept from the JAX function: each pixel is normalized as
// (v / 255 - mean[c]) / std[c] in fp32 and rounded to the kernel's dtype;
// the product accumulates in fp32; the bias is added in fp32; the output is
// in the kernel's dtype. The (frames, N, p*p*3) patch tensor is never written
// to device memory (the TPU kernel's transpose-free row blocking is a
// Mosaic artefact and is not carried over).
//
// What bounds it on an H100: at 8 clips x 8 frames of 224^2 it is 14.8 GFLOP
// against 9.6 MB of pixels, 1.2 MB of kernel and 19.3 MB of output, so the
// tensor cores bound it (0.015 ms). Design: the row-tile GEMM of
// row_tile.cuh. One block of 16 warps per 32 patches gathers their pixels
// (each patch row is p*3 contiguous bytes of a frame row, read by
// neighbouring threads), normalizes them into a shared (32 x p*p*3) tile in
// the kernel's dtype, then multiplies it by the kernel in 128 x 128 tiles with
// the D output columns in registers (one 16x16 fp32 tile per warp and
// 128-column group), and writes + bias through a per-warp stage buffer.
// bf16 products run on the tensor cores (WMMA), fp32 on the CUDA cores.
#include <cstdint>

#include "row_tile.cuh"

namespace {

using alpro::WarpTile;
using namespace alpro::rows;

template <typename T>
size_t smem_bytes(int K) {
  return size_t(kTM) * (K + vec<T>()) * sizeof(T)            // normalized patch tile
         + size_t(kTile) * (kTile + vec<T>()) * sizeof(T)    // kernel tile
         + size_t(kWarps) * 256 * 4;                          // per-warp stage
}

struct Norm {
  float mean[3], std[3];
};

template <typename T, int NG>  // D = NG * 128
__global__ void __launch_bounds__(kThreads, 1)
patchify_embed_kernel(const uint8_t* __restrict__ raw, const T* __restrict__ kernel,
                      const float* __restrict__ bias, T* __restrict__ out, int R, int H, int W,
                      int p, int N, int wp, Norm nrm) {
  constexpr int D = NG * kTile;
  const int K = p * p * 3, seg = p * 3, ldx = K + vec<T>();
  const int r0 = blockIdx.x * kTM;
  const int warp = threadIdx.x >> 5;

  extern __shared__ __align__(128) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  T* wt = xs + kTM * ldx;
  float* stage = reinterpret_cast<float*>(wt + kTile * (kTile + vec<T>())) + warp * 256;

  // ---- gather + normalize: column k = (i, j, c) of patch row r is pixel
  //      (ph * p + i, pw * p + j, c); zero past R ----
  for (int e = threadIdx.x; e < kTM * K; e += kThreads) {
    const int r = e / K, k = e % K, row = r0 + r;
    float v = 0.0f;
    if (row < R) {
      const int f = row / N, n = row % N;
      const int i = k / seg, jc = k % seg, c = jc % 3;
      const long pix = (long(f) * H + (n / wp) * p + i) * W * 3 + (n % wp) * seg + jc;
      v = (float(raw[pix]) / 255.0f - nrm.mean[c]) / nrm.std[c];
    }
    xs[r * ldx + k] = alpro::from_f32<T>(v);
  }

  WarpTile<T> acc[NG];
#pragma unroll
  for (int g = 0; g < NG; ++g) acc[g].zero();
  gemm<T, NG, false>(acc, xs, ldx, kernel, D, K / kTile, wt);  // begins with a block sync
  store_rows<T, NG>(acc, stage, bias, nullptr, out, D, 0, r0, R);
}

template <typename T, int NG>
int launch(const void* raw, const void* kernel, const void* bias, void* out, int frames, int H,
           int W, int p, const Norm& nrm, cudaStream_t stream) {
  const int hp = H / p, wp = W / p, N = hp * wp, R = frames * N;
  const size_t smem = smem_bytes<T>(p * p * 3);
  cudaError_t err = cudaFuncSetAttribute(patchify_embed_kernel<T, NG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  patchify_embed_kernel<T, NG><<<(R + kTM - 1) / kTM, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(raw), static_cast<const T*>(kernel),
      static_cast<const float*>(bias), static_cast<T*>(out), R, H, W, p, N, wp, nrm);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch(const void* raw, const void* kernel, const void* bias, void* out, int frames, int H,
             int W, int p, int D, const Norm& nrm, cudaStream_t st) {
  switch (D) {
#define ALPRO_PATCHIFY_CASE(NG) \
  case NG * kTile: return launch<T, NG>(raw, kernel, bias, out, frames, H, W, p, nrm, st);
    ALPRO_PATCHIFY_CASE(2)
    ALPRO_PATCHIFY_CASE(4)
    ALPRO_PATCHIFY_CASE(6)
    ALPRO_PATCHIFY_CASE(8)
#undef ALPRO_PATCHIFY_CASE
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// raw (frames, H, W, 3) uint8; kernel (p*p*3, D) bf16 or fp32, out (frames,
// N, D) in its dtype; bias fp32. p*p*3 % 128 == 0 (up to 1024), D in (256,
// 512, 768, 1024).
extern "C" int alpro_patchify_embed(const void* raw, const void* kernel, const void* bias,
                                    void* out, int frames, int H, int W, int p, int D, float m0,
                                    float m1, float m2, float s0, float s1, float s2, int is_bf16,
                                    int device, void* stream) {
  const int K = p * p * 3;
  if (frames < 1 || p < 1 || H < p || W < p || K % alpro::rows::kTile || K > 1024)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const Norm nrm{{m0, m1, m2}, {s0, s1, s2}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(raw, kernel, bias, out, frames, H, W, p, D, nrm, st)
                 : dispatch<float>(raw, kernel, bias, out, frames, H, W, p, D, nrm, st);
}
