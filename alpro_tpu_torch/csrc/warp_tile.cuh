// Shared device helpers of the port's kernels.
//
// WarpTile<T>: one warp's 16x16 fp32 accumulator tile, C += A(16x16) * B(16x16)
// with A row-major and B row- or column-major, on the CUDA cores in full fp32
// (lane l owns row l/2, columns 8*(l%2)..+8): the fp32 routes' products (every
// bf16 product runs on wgmma). After store() other lanes may read the tile
// only after __syncwarp().
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace alpro {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// the shared memory a block may opt in to on this device (0 if unknown)
inline int max_smem_optin(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, device) != cudaSuccess)
    return 0;
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename T> struct WarpTile;

template <> struct WarpTile<float> {
  float c[8];

  __device__ __forceinline__ int row() const { return (threadIdx.x & 31) >> 1; }
  __device__ __forceinline__ int col0() const { return (threadIdx.x & 1) * 8; }
  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int j = 0; j < 8; ++j) c[j] = 0.0f;
  }
  __device__ __forceinline__ void load(const float* p, int ld) {
#pragma unroll
    for (int j = 0; j < 8; ++j) c[j] = p[row() * ld + col0() + j];
  }
  __device__ __forceinline__ void store(float* p, int ld) {
#pragma unroll
    for (int j = 0; j < 8; ++j) p[row() * ld + col0() + j] = c[j];
  }
  template <bool kBColMajor>
  __device__ __forceinline__ void mma(const float* a, int lda, const float* b, int ldb) {
    const int r = row(), c0 = col0();
#pragma unroll 4
    for (int k = 0; k < 16; ++k) {
      const float av = a[r * lda + k];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float bv = kBColMajor ? b[(c0 + j) * ldb + k] : b[k * ldb + c0 + j];
        c[j] = fmaf(av, bv, c[j]);
      }
    }
  }
};

}  // namespace alpro
