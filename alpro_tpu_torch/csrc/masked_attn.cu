// Masked multi-head attention on strided q, k, v: one kernel for the
// (B, S, H·hd) and (B, H, S, hd) layouts.
//
// Replaces the TPU kernels alpro_tpu/ops/pallas_attn.py::fused_attention_bshd
// (_attn_kernel_heads) and ::fused_attention (_attn_kernel), which share one
// body. Contract kept from them, tiling not:
//   * q, k, v and the output are read and written in place through their
//     (batch, sequence, head) element strides, head_dim contiguous: the packed
//     [q | k | v] projection and the flat (B, S, H·hd) channels need no
//     head-split copies, and (B, H, S, hd) is the same kernel with other
//     strides;
//   * scores are q·kᵀ on the stored operands with fp32 accumulation, times the
//     scale, plus the fp32 key bias (1 - mask)·-10000; the row max and the exp
//     are fp32 over the Sk keys (keys past Sk never contribute: the TPU's pad
//     to 128 with -1e9 is tiling only); the unnormalised p is rounded to v's
//     dtype for P·V with fp32 accumulation; the division by the fp32 row sum
//     comes last, then the cast to the output dtype.
//
// What bounds it on an H100: per (sequence, head) two Sq x Sk x hd products
// over (Sq + 2 Sk)·hd operands, 10 MFLOP over 75 KB at S = 197; at the
// spatial shape (64 frames x 12 heads) the least time is set by the bytes
// (78 MB, 23 us, against 8 us of bf16 tensor-core work), and this simple
// kernel is far from either: its time goes to staging K and V per query tile,
// computing the scores twice and the per-lane softmax. Design: one block
// per (query tile, head, sequence) stages the head's K and V (Sk x hd, zero
// past Sk) and the key bias in shared memory; each warp owns 16 query rows and
// walks the keys in chunks of 64 twice — first for the exact fp32 row max,
// then for p = exp(s - max), whose sum stays fp32 while its rounded copy
// feeds the P·V product, accumulated in registers across chunks. The row max
// is known before any p is rounded, as in the TPU kernel, so the result does
// not depend on the chunking (an online softmax would round p against a
// running max). Only one 16 x 64 score chunk per warp lives in shared memory,
// so the length is limited only by K and V of one head: 848 keys in bf16 at
// hd = 64 on an H100 (227 KB of shared memory a block), past the model's
// longest sequence, 512 text + 197 video = 709.
// bf16 products run on the tensor cores (WMMA 16x16x16); fp32 inputs take the
// same code on the CUDA cores (warp_tile.cuh).
#include <cstdint>

#include "warp_tile.cuh"

namespace {

constexpr int kKC = 64;        // keys per chunk
constexpr int kMaxWarps = 8;   // 16 query rows per warp
constexpr int kLdP = kKC + 8;  // p chunk leading dimension (elements)

// fp32 score chunk, and at the end the 16 x hd output tile, leading dimension
template <int HD> __host__ __device__ constexpr int ld_scores() {
  return (kKC > HD ? kKC : HD) + 4;
}

struct Strides {
  long long b, s, h;  // elements; the head_dim axis has stride 1
};

template <typename T, int HD>
size_t smem_bytes(int SKP, int warps) {
  return 2 * size_t(SKP) * HD * sizeof(T)             // K, V of the head
         + size_t(warps) * 16 * HD * sizeof(T)         // Q tile
         + size_t(SKP) * 4                             // key bias
         + size_t(warps) * 16 * ld_scores<HD>() * 4    // per-warp fp32 score chunk
         + size_t(warps) * 16 * kLdP * sizeof(T);      // per-warp p chunk
}

// s = Q (16 x HD) · K_chunkᵀ for nt 16-key tiles, stored fp32 at Sc
template <typename T, int HD>
__device__ __forceinline__ void score_chunk(const T* Qw, const T* Kc, int nt, float* Sc) {
  for (int j = 0; j < nt; ++j) {
    alpro::WarpTile<T> acc;
    acc.zero();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      acc.template mma<true>(Qw + kk * 16, HD, Kc + j * 16 * HD + kk * 16, HD);
    acc.store(Sc + j * 16, ld_scores<HD>());
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kMaxWarps * 32)
masked_attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const float* __restrict__ bias, T* __restrict__ out, Strides sq, Strides sk,
                   Strides sv, Strides so, int Sq, int Sk, int SKP, float scale) {
  constexpr int kLdS = ld_scores<HD>();
  constexpr int kCpr = HD * int(sizeof(T)) / 16;  // 16-byte chunks per head row
  const int warps = blockDim.x >> 5, QT = warps * 16;
  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + SKP * HD;
  T* Qs = Vs + SKP * HD;
  float* bs = reinterpret_cast<float*>(Qs + QT * HD);
  float* Sc = bs + SKP + warp * 16 * kLdS;
  T* Pc = reinterpret_cast<T*>(bs + SKP + warps * 16 * kLdS) + warp * 16 * kLdP;

  // ---- stage K, V (SKP rows, zero past Sk), the Q tile and the key bias ----
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  for (int i = threadIdx.x; i < SKP * kCpr; i += blockDim.x) {
    const int r = i / kCpr, c = i % kCpr;
    uint4 kv = make_uint4(0, 0, 0, 0), vv = kv;
    if (r < Sk) {
      kv = reinterpret_cast<const uint4*>(kb + r * sk.s)[c];
      vv = reinterpret_cast<const uint4*>(vb + r * sv.s)[c];
    }
    reinterpret_cast<uint4*>(Ks + r * HD)[c] = kv;
    reinterpret_cast<uint4*>(Vs + r * HD)[c] = vv;
  }
  const T* qb = q + b * sq.b + h * sq.h;
  for (int i = threadIdx.x; i < QT * kCpr; i += blockDim.x) {
    const int r = i / kCpr, c = i % kCpr, s = q0 + r;
    uint4 qv = make_uint4(0, 0, 0, 0);
    if (s < Sq) qv = reinterpret_cast<const uint4*>(qb + s * sq.s)[c];
    reinterpret_cast<uint4*>(Qs + r * HD)[c] = qv;
  }
  for (int c = threadIdx.x; c < SKP; c += blockDim.x) bs[c] = c < Sk ? bias[long(b) * Sk + c] : 0.0f;
  __syncthreads();

  const int r0 = warp * 16;
  if (q0 + r0 >= Sq) return;  // no valid query row in this warp (no block syncs follow)
  const T* Qw = Qs + r0 * HD;
  // lane (row, half) owns chunk columns 2i + half of row `row`
  const int row = lane >> 1, half = lane & 1;

  // ---- pass 1: the fp32 row max of s·scale + bias over the Sk keys ----
  float mx = -INFINITY;
  for (int c0 = 0; c0 < SKP; c0 += kKC) {
    score_chunk<T, HD>(Qw, Ks + c0 * HD, min(kKC, SKP - c0) / 16, Sc);
    __syncwarp();
    for (int i = 0; i < kKC / 2; ++i) {
      const int c = 2 * i + half;
      if (c0 + c < Sk) mx = fmaxf(mx, Sc[row * kLdS + c] * scale + bs[c0 + c]);
    }
    __syncwarp();
  }
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));

  // ---- pass 2: p = exp(s - max); l += p in fp32; o += round(p) · V ----
  alpro::WarpTile<T> acc[HD / 16];
#pragma unroll
  for (int jj = 0; jj < HD / 16; ++jj) acc[jj].zero();
  float l = 0.0f;
  for (int c0 = 0; c0 < SKP; c0 += kKC) {
    const int nt = min(kKC, SKP - c0) / 16;
    score_chunk<T, HD>(Qw, Ks + c0 * HD, nt, Sc);
    __syncwarp();
    for (int i = 0; i < kKC / 2; ++i) {
      const int c = 2 * i + half;
      float p = 0.0f;
      if (c0 + c < Sk) {
        p = expf(Sc[row * kLdS + c] * scale + bs[c0 + c] - mx);
        l += p;
      }
      Pc[row * kLdP + c] = alpro::from_f32<T>(p);
    }
    __syncwarp();
#pragma unroll
    for (int jj = 0; jj < HD / 16; ++jj)
      for (int j = 0; j < nt; ++j)
        acc[jj].template mma<false>(Pc + j * 16, kLdP, Vs + (c0 + j * 16) * HD + jj * 16, HD);
    __syncwarp();
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);

  // ---- o / l in the output dtype, through the score chunk ----
#pragma unroll
  for (int jj = 0; jj < HD / 16; ++jj) acc[jj].store(Sc + jj * 16, kLdS);
  __syncwarp();
  const int s = q0 + r0 + row;
  if (s < Sq) {
    T* orow = out + b * so.b + s * so.s + h * so.h;
    for (int c = half * (HD / 2); c < (half + 1) * (HD / 2); ++c)
      orow[c] = alpro::from_f32<T>(Sc[row * kLdS + c] / l);
  }
}

template <typename T, int HD>
int max_seq(int device) {
  int limit = 0;
  cudaError_t err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return -int(err);
  int SKP = 16;
  while (smem_bytes<T, HD>(SKP + 16, 1) <= size_t(limit)) SKP += 16;
  return SKP;
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const float* bias, void* out,
           Strides sq, Strides sk, Strides sv, Strides so, int B, int H, int Sq, int Sk,
           float scale, int device, cudaStream_t stream) {
  int limit = 0;
  cudaError_t err = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return int(err);
  const int SKP = (Sk + 15) / 16 * 16;
  int warps = min(kMaxWarps, (Sq + 15) / 16);
  while (warps > 1 && smem_bytes<T, HD>(SKP, warps) > size_t(limit)) --warps;
  const size_t smem = smem_bytes<T, HD>(SKP, warps);
  if (smem > size_t(limit)) return int(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(masked_attn_kernel<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid((Sq + warps * 16 - 1) / (warps * 16), H, B);
  masked_attn_kernel<T, HD><<<grid, warps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias,
      static_cast<T*>(out), sq, sk, sv, so, Sq, Sk, SKP, scale);
  return int(cudaGetLastError());
}

template <typename T>
int dispatch(int hd, const void* q, const void* k, const void* v, const float* bias, void* out,
             Strides sq, Strides sk, Strides sv, Strides so, int B, int H, int Sq, int Sk,
             float scale, int device, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, bias, out, sq, sk, sv, so, B, H, Sq, Sk, scale, device, stream);
    case 64: return launch<T, 64>(q, k, v, bias, out, sq, sk, sv, so, B, H, Sq, Sk, scale, device, stream);
    case 128: return launch<T, 128>(q, k, v, bias, out, sq, sk, sv, so, B, H, Sq, Sk, scale, device, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// strides: (batch, sequence, head) element strides of q, k, v and out, in
// that order (12 values); bias: (B, Sk) fp32
extern "C" int alpro_masked_attn(const void* q, const void* k, const void* v, const float* bias,
                                 void* out, const long long* strides, int B, int H, int Sq, int Sk,
                                 int hd, float scale, int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const Strides sq{strides[0], strides[1], strides[2]}, sk{strides[3], strides[4], strides[5]},
      sv{strides[6], strides[7], strides[8]}, so{strides[9], strides[10], strides[11]};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(hd, q, k, v, bias, out, sq, sk, sv, so, B, H, Sq, Sk,
                                           scale, device, s)
                 : dispatch<float>(hd, q, k, v, bias, out, sq, sk, sv, so, B, H, Sq, Sk, scale,
                                   device, s);
}

// the largest Sk the kernel takes for (dtype, hd) on `device` (K and V of one
// head in shared memory with one warp), or minus a CUDA error code
extern "C" int alpro_masked_attn_max_seq(int is_bf16, int hd, int device) {
  switch (hd) {
    case 32: return is_bf16 ? max_seq<__nv_bfloat16, 32>(device) : max_seq<float, 32>(device);
    case 64: return is_bf16 ? max_seq<__nv_bfloat16, 64>(device) : max_seq<float, 64>(device);
    case 128: return is_bf16 ? max_seq<__nv_bfloat16, 128>(device) : max_seq<float, 128>(device);
    default: return 0;
  }
}
