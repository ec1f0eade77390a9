// K2's body: attention over T on packed qkv in the model's native layout,
// (B, T, N, 3D) -> (B, T, N, D), at each (b, n) and head. Shared by K2 and
// B16 (csrc/temporal_attn.cu) and B10's bf16 route (csrc/fused_block.cu),
// which runs it on the (R, 3D) qkv scratch of its LN -> qkv GEMM; each .cu
// owns its instantiations (an unnamed namespace).
//
// Replaces the TPU kernel alpro_tpu/ops/pallas_qkv_attn.py::
// fused_temporal_attention_qkv (_temporal_kernel; its off-by-flag lowerings
// _temporal_kernel_flash and _temporal_kernel_seg compute the same). Contract
// kept from it: q, k, v read in place from the (B, T, N, 3D) tensor and the
// output written as (B, T, N, D), with no relayout to (B*N, T, D); all math
// in fp32 with q pre-scaled; softmax as max, exp, sum, then sum_u p_u v_u / l.
// The delta-roll formulation and the N blocking are Mosaic/VMEM artefacts and
// are not carried over.
//
// What bounds it on an H100: per (b, n, head) it is a T x T score block over
// hd = 64 — about 2*T*T*hd FLOP against 3*T*hd elements read — so it moves
// bytes, not FLOPs: at the flagship shape it reads the qkv tensor once and
// writes the output once. Design: one warp per (b, n, head), lanes over the
// head's channels (hd*sizeof(T) contiguous bytes per frame row, so every load
// and store is coalesced). Each lane keeps its channels of k and v for all T
// frames in a lane-private slice of shared memory; a score is a lane-partial
// dot product and a butterfly warp reduction, lane u keeps score u, and the
// softmax over T <= 32 scores is a warp max and warp sum.
//
// The same function also replaces alpro_tpu/ops/pallas_temporal_attn.py::
// temporal_attention_roll (B16): its kernel scales q in fp32, takes the fp32
// bands q.k over every key, then max, exp, sum and sum_u p_u v_u / l, rounded
// once, which is the contract above (the delta order of its sums is Mosaic
// tiling). What B16 adds is the envelope: any head_dim and any T. The fast
// path above keeps head_dim in (32, 64, 96, 128) and T <= 32;
// temporal_attn_wide takes every head_dim that is a multiple of 8 up to 128
// (lane l holds channels l, l + 32, ..; lanes past head_dim idle) and
// T <= kMaxT (lane l holds scores u = l, l + 32, ..), with as many warps per
// block as the warps' fp32 K and V (2 * T * head_dim floats each) fit in
// shared memory.
#pragma once

#include <algorithm>

#include "warp_tile.cuh"

namespace alpro {
namespace tattn {
namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxT = 128;  // temporal_attn_wide: up to 4 scores per lane

template <typename T, int VPL>  // VPL = hd / 32 channels per lane
__global__ void __launch_bounds__(kThreads)
temporal_attn_kernel(const T* __restrict__ qkv, T* __restrict__ out, int B, int Tn, int N,
                     int H, float scale) {
  constexpr int hd = 32 * VPL;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long gw = long(blockIdx.x) * kWarps + warp;
  if (gw >= long(B) * N * H) return;
  const int h = int(gw % H);
  const int n = int((gw / H) % N);
  const int b = int(gw / (long(H) * N));
  const int D = H * hd;
  const long ld = 3L * D;

  extern __shared__ __align__(16) float tsmem[];
  float* kf = tsmem + size_t(warp) * 2 * Tn * hd;  // (Tn, hd), lane-private columns
  float* vf = kf + Tn * hd;
  const int c0 = lane * VPL;

  // row (b, u, n) of the packed tensor
  auto row = [&](int u) { return qkv + ((long(b) * Tn + u) * N + n) * ld; };
  for (int u = 0; u < Tn; ++u) {
    const T* r = row(u);
#pragma unroll
    for (int i = 0; i < VPL; ++i) {
      kf[u * hd + c0 + i] = alpro::to_f32(r[D + h * hd + c0 + i]);
      vf[u * hd + c0 + i] = alpro::to_f32(r[2 * D + h * hd + c0 + i]);
    }
  }

  for (int t = 0; t < Tn; ++t) {
    float q[VPL];
    const T* r = row(t);
#pragma unroll
    for (int i = 0; i < VPL; ++i) q[i] = alpro::to_f32(r[h * hd + c0 + i]) * scale;
    float my_s = -INFINITY;  // lane u holds score (t, u)
    for (int u = 0; u < Tn; ++u) {
      float part = 0.0f;
#pragma unroll
      for (int i = 0; i < VPL; ++i) part = fmaf(q[i], kf[u * hd + c0 + i], part);
      part = alpro::warp_sum(part);
      if (lane == u) my_s = part;
    }
    const float mx = alpro::warp_max(my_s);
    const float p = lane < Tn ? expf(my_s - mx) : 0.0f;
    const float l = alpro::warp_sum(p);
    float o[VPL];
#pragma unroll
    for (int i = 0; i < VPL; ++i) o[i] = 0.0f;
    for (int u = 0; u < Tn; ++u) {
      const float pu = __shfl_sync(0xffffffffu, p, u);
#pragma unroll
      for (int i = 0; i < VPL; ++i) o[i] = fmaf(pu, vf[u * hd + c0 + i], o[i]);
    }
    T* orow = out + ((long(b) * Tn + t) * N + n) * D + h * hd;
#pragma unroll
    for (int i = 0; i < VPL; ++i) orow[c0 + i] = alpro::from_f32<T>(o[i] / l);
  }
}

template <typename T, int VPL>
int launch(const void* qkv, void* out, int B, int Tn, int N, int H, float scale,
           cudaStream_t stream) {
  const size_t smem = size_t(kWarps) * 2 * Tn * 32 * VPL * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(temporal_attn_kernel<T, VPL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return int(err);
  const long warps = long(B) * N * H;
  const unsigned blocks = unsigned((warps + kWarps - 1) / kWarps);
  temporal_attn_kernel<T, VPL><<<blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), B, Tn, N, H, scale);
  return int(cudaGetLastError());
}

// Lane l: channels c = l + 32 i (i < VPC, c < hd) and scores u = l + 32 j
// (j < SPL, u < Tn); wpb warps per block.
template <typename T, int VPC, int SPL>
__global__ void __launch_bounds__(kThreads)
temporal_attn_wide(const T* __restrict__ qkv, T* __restrict__ out, int B, int Tn, int N, int H,
                   int hd, int wpb, float scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long gw = long(blockIdx.x) * wpb + warp;
  if (gw >= long(B) * N * H) return;
  const int h = int(gw % H);
  const int n = int((gw / H) % N);
  const int b = int(gw / (long(H) * N));
  const int D = H * hd;
  const long ld = 3L * D;

  extern __shared__ __align__(16) float tsmem[];
  float* kf = tsmem + size_t(warp) * 2 * Tn * hd;  // (Tn, hd), lane-private columns
  float* vf = kf + Tn * hd;

  auto row = [&](int u) { return qkv + ((long(b) * Tn + u) * N + n) * ld; };
  for (int u = 0; u < Tn; ++u) {
    const T* r = row(u);
#pragma unroll
    for (int i = 0; i < VPC; ++i) {
      const int c = lane + 32 * i;
      if (c < hd) {
        kf[u * hd + c] = alpro::to_f32(r[D + h * hd + c]);
        vf[u * hd + c] = alpro::to_f32(r[2 * D + h * hd + c]);
      }
    }
  }

  for (int t = 0; t < Tn; ++t) {
    float q[VPC];
    const T* r = row(t);
#pragma unroll
    for (int i = 0; i < VPC; ++i) {
      const int c = lane + 32 * i;
      q[i] = c < hd ? alpro::to_f32(r[h * hd + c]) * scale : 0.0f;
    }
    float s[SPL];  // lane l holds scores (t, l + 32 j)
#pragma unroll
    for (int j = 0; j < SPL; ++j) {
      s[j] = -INFINITY;
      for (int v = 0; v < 32 && 32 * j + v < Tn; ++v) {
        const int u = 32 * j + v;
        float part = 0.0f;
#pragma unroll
        for (int i = 0; i < VPC; ++i) {
          const int c = lane + 32 * i;
          if (c < hd) part = fmaf(q[i], kf[u * hd + c], part);
        }
        part = alpro::warp_sum(part);
        if (lane == v) s[j] = part;
      }
    }
    float mx = s[0];
#pragma unroll
    for (int j = 1; j < SPL; ++j) mx = fmaxf(mx, s[j]);
    mx = alpro::warp_max(mx);
    float p[SPL], l = 0.0f;
#pragma unroll
    for (int j = 0; j < SPL; ++j) {
      p[j] = 32 * j + lane < Tn ? expf(s[j] - mx) : 0.0f;
      l += p[j];
    }
    l = alpro::warp_sum(l);
    float o[VPC];
#pragma unroll
    for (int i = 0; i < VPC; ++i) o[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < SPL; ++j)
      for (int v = 0; v < 32 && 32 * j + v < Tn; ++v) {
        const int u = 32 * j + v;
        const float pu = __shfl_sync(0xffffffffu, p[j], v);
#pragma unroll
        for (int i = 0; i < VPC; ++i) {
          const int c = lane + 32 * i;
          if (c < hd) o[i] = fmaf(pu, vf[u * hd + c], o[i]);
        }
      }
    T* orow = out + ((long(b) * Tn + t) * N + n) * D + h * hd;
#pragma unroll
    for (int i = 0; i < VPC; ++i) {
      const int c = lane + 32 * i;
      if (c < hd) orow[c] = alpro::from_f32<T>(o[i] / l);
    }
  }
}

template <typename T, int VPC, int SPL>
int launch_wide(const void* qkv, void* out, int B, int Tn, int N, int H, int hd, float scale,
                int device, cudaStream_t stream) {
  const size_t per_warp = 2 * size_t(Tn) * hd * sizeof(float);
  const size_t limit = size_t(alpro::max_smem_optin(device));
  if (per_warp > limit) return int(cudaErrorInvalidValue);
  const int wpb = int(std::min<size_t>(kWarps, limit / per_warp));
  const size_t smem = wpb * per_warp;
  cudaError_t err = cudaFuncSetAttribute(temporal_attn_wide<T, VPC, SPL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return int(err);
  const long warps = long(B) * N * H;
  const unsigned blocks = unsigned((warps + wpb - 1) / wpb);
  temporal_attn_wide<T, VPC, SPL><<<blocks, wpb * 32, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), B, Tn, N, H, hd, wpb, scale);
  return int(cudaGetLastError());
}

template <typename T, int VPC>
int dispatch_wide(const void* qkv, void* out, int B, int Tn, int N, int H, int hd, float scale,
                  int device, cudaStream_t s) {
  switch ((Tn + 31) / 32) {
    case 1: return launch_wide<T, VPC, 1>(qkv, out, B, Tn, N, H, hd, scale, device, s);
    case 2: return launch_wide<T, VPC, 2>(qkv, out, B, Tn, N, H, hd, scale, device, s);
    case 3: return launch_wide<T, VPC, 3>(qkv, out, B, Tn, N, H, hd, scale, device, s);
    case 4: return launch_wide<T, VPC, 4>(qkv, out, B, Tn, N, H, hd, scale, device, s);
    default: return int(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch(const void* qkv, void* out, int B, int Tn, int N, int H, int hd, float scale,
             int device, cudaStream_t s) {
  // the fast path where it applies and its four warps' K and V fit
  const bool fast = Tn <= 32 && size_t(kWarps) * 2 * Tn * hd * sizeof(float) <=
                                    size_t(alpro::max_smem_optin(device));
  if (fast) {
    switch (hd) {
      case 32: return launch<T, 1>(qkv, out, B, Tn, N, H, scale, s);
      case 64: return launch<T, 2>(qkv, out, B, Tn, N, H, scale, s);
      case 96: return launch<T, 3>(qkv, out, B, Tn, N, H, scale, s);
      case 128: return launch<T, 4>(qkv, out, B, Tn, N, H, scale, s);
      default: break;
    }
  }
  switch ((hd + 31) / 32) {
    case 1: return dispatch_wide<T, 1>(qkv, out, B, Tn, N, H, hd, scale, device, s);
    case 2: return dispatch_wide<T, 2>(qkv, out, B, Tn, N, H, hd, scale, device, s);
    case 3: return dispatch_wide<T, 3>(qkv, out, B, Tn, N, H, hd, scale, device, s);
    case 4: return dispatch_wide<T, 4>(qkv, out, B, Tn, N, H, hd, scale, device, s);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace tattn
}  // namespace alpro
