// Temporal attention over packed qkv in the model's native layout:
// (B, T, N, 3D) -> (B, T, N, D), attending over T at each (b, n) and head.
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
#include "warp_tile.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

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

template <typename T>
int dispatch(const void* qkv, void* out, int B, int Tn, int N, int H, int hd, float scale,
             cudaStream_t s) {
  switch (hd) {
    case 32: return launch<T, 1>(qkv, out, B, Tn, N, H, scale, s);
    case 64: return launch<T, 2>(qkv, out, B, Tn, N, H, scale, s);
    case 96: return launch<T, 3>(qkv, out, B, Tn, N, H, scale, s);
    case 128: return launch<T, 4>(qkv, out, B, Tn, N, H, scale, s);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int alpro_temporal_attn(const void* qkv, void* out, int B, int Tn, int N, int H,
                                   int hd, float scale, int is_bf16, int device,
                                   void* stream) {
  if (Tn < 1 || Tn > 32) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16>(qkv, out, B, Tn, N, H, hd, scale, s)
                 : dispatch<float>(qkv, out, B, Tn, N, H, hd, scale, s);
}
