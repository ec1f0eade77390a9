// Row LayerNorm: out = (x - mean) * rsqrt(var + eps) * scale + bias over the
// last axis, rows (R, D), x in bf16 or fp32, out in bf16 or fp32 (the two
// may differ), scale and bias fp32.
//
// Replaces the TPU kernel alpro_tpu/ops/pallas_layernorm.py::fused_layernorm
// (_ln_kernel). Contract kept from it: one-pass fp32 statistics, E[x^2] -
// E[x]^2 clamped at 0, fp32 scale and bias, one cast on the write. Its
// backward (the custom_vjp's analytic _bwd) is plain torch in
// ops/layernorm.py, as the JAX one is XLA code.
//
// What bounds it on an H100: 8 FLOP per element against 4 bytes (bf16 in
// and out), so bytes: at (12608, 768) bf16 about 39 MB, 11.6 us at 3.35
// TB/s. Design: one warp per row, the row held in registers — each lane NC
// chunks of 8 consecutive elements (16-byte loads of bf16, two of fp32),
// all issued before the first is used — a warp reduction for the two sums,
// then the normalized chunks written with the same vector width, scale and
// bias read as float4. No shared memory, 8 rows per block; D <= 2048.
#include "warp_tile.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kVec = 8;  // elements per chunk
constexpr int kMaxChunks = 8;  // chunks per lane: D <= 32 * 8 * 8

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[kVec]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* b = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int q = 0; q < kVec; ++q) v[q] = __bfloat162float(b[q]);
}

__device__ __forceinline__ void load8(const float* p, float (&v)[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w, v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[kVec]) {
  alignas(16) __nv_bfloat16 b[kVec];
#pragma unroll
  for (int q = 0; q < kVec; ++q) b[q] = __float2bfloat16_rn(v[q]);
  *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(b);
}

__device__ __forceinline__ void store8(float* p, const float (&v)[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// NC: chunks per lane, ceil(D / (32 * kVec)); chunk i of a lane starts at
// element (i * 32 + lane) * kVec
template <typename Ti, typename To, int NC>
__global__ void __launch_bounds__(kThreads)
layernorm_kernel(const Ti* __restrict__ x, const float* __restrict__ scale,
                 const float* __restrict__ bias, To* __restrict__ out, long R, int D, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long row = long(blockIdx.x) * kWarps + warp;
  if (row >= R) return;
  const Ti* xr = x + row * D;
  float v[NC][kVec];
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = (i * 32 + lane) * kVec;
    if (c < D) load8(xr + c, v[i]);
  }
  float s = 0.0f, ss = 0.0f;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    if ((i * 32 + lane) * kVec >= D) continue;
#pragma unroll
    for (int q = 0; q < kVec; ++q) {
      s += v[i][q];
      ss = fmaf(v[i][q], v[i][q], ss);
    }
  }
  s = alpro::warp_sum(s);
  ss = alpro::warp_sum(ss);
  const float mean = s / D;
  const float rstd = rsqrtf(fmaxf(ss / D - mean * mean, 0.0f) + eps);
  To* orow = out + row * D;
#pragma unroll
  for (int i = 0; i < NC; ++i) {
    const int c = (i * 32 + lane) * kVec;
    if (c >= D) continue;
    float g[kVec], b[kVec];
    load8(scale + c, g);
    load8(bias + c, b);
#pragma unroll
    for (int q = 0; q < kVec; ++q) v[i][q] = (v[i][q] - mean) * rstd * g[q] + b[q];
    store8(orow + c, v[i]);
  }
}

template <typename Ti, typename To, int NC>
int launch(const void* x, const void* scale, const void* bias, void* out, long R, int D, float eps,
           cudaStream_t stream) {
  const long blocks = (R + kWarps - 1) / kWarps;
  layernorm_kernel<Ti, To, NC><<<unsigned(blocks), kThreads, 0, stream>>>(
      static_cast<const Ti*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(bias), static_cast<To*>(out), R, D, eps);
  return int(cudaGetLastError());
}

template <typename Ti, typename To>
int dispatch(const void* x, const void* scale, const void* bias, void* out, long R, int D,
             float eps, cudaStream_t s) {
  switch ((D + 32 * kVec - 1) / (32 * kVec)) {
#define ALPRO_LN_CASE(NC) \
  case NC: return launch<Ti, To, NC>(x, scale, bias, out, R, D, eps, s);
    ALPRO_LN_CASE(1)
    ALPRO_LN_CASE(2)
    ALPRO_LN_CASE(3)
    ALPRO_LN_CASE(4)
    ALPRO_LN_CASE(5)
    ALPRO_LN_CASE(6)
    ALPRO_LN_CASE(7)
    ALPRO_LN_CASE(8)
#undef ALPRO_LN_CASE
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// x (R, D) in bf16 or fp32 (in_bf16), out (R, D) in bf16 or fp32
// (out_bf16), scale and bias (D,) fp32; D % 8 == 0, D <= 2048, 16-byte
// aligned rows.
extern "C" int alpro_layernorm(const void* x, const void* scale, const void* bias, void* out,
                               int R, int D, float eps, int in_bf16, int out_bf16, int device,
                               void* stream) {
  if (R < 1 || D < kVec || D % kVec || D > 32 * kVec * kMaxChunks)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  using bf16 = __nv_bfloat16;
  if (in_bf16)
    return out_bf16 ? dispatch<bf16, bf16>(x, scale, bias, out, R, D, eps, s)
                    : dispatch<bf16, float>(x, scale, bias, out, R, D, eps, s);
  return out_bf16 ? dispatch<float, bf16>(x, scale, bias, out, R, D, eps, s)
                  : dispatch<float, float>(x, scale, bias, out, R, D, eps, s);
}
