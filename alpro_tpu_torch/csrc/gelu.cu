// Exact-erf GELU of the training path, forward and backward, each one pass
// over device memory, h and the results in bf16 or fp32 (contiguous).
//
// Replaces no TPU kernel: on the TPU, XLA fused this pointwise chain
// (ops/kernel_math.py::gelu_exact_f32(x).to(x.dtype)) into its neighbours.
// Run eagerly by PyTorch it is seven launches forward (the fp32 cast,
// x * 2^-1/2, erf, 1 +, x * 0.5, the product, the cast back), replayed in a
// checkpointed block's recompute, and about a dozen in autograd's backward,
// each an fp32 pass over the whole (rows, 3072) hidden.
//
// gelu_fwd: g = (h * 0.5) * (1 + erff(h * 0.70710677f)), the twin's fp32
// operations in the twin's order, each rounded on its own (__fmul_rn,
// __fadd_rn: no FMA contraction), rounded once to h's dtype: bit-equal to
// the twin on the card.
// gelu_bwd: dh = dg * gelu'(h), as autograd's backward through the twin
// computes it (erf's derivative 2/sqrt(pi) * exp(-u^2) at u = h * 2^-1/2,
// the two branches' products, their sum), in fp32 registers, rounded once
// to h's dtype.
//
// What bounds it on an H100: bytes. The forward reads h and writes g (4
// bytes an element in bf16), the backward reads h and dg and writes dh (6):
// at the training path's (75264, 3072) in bf16, 0.925 GB and 1.387 GB, so
// 0.276 ms and 0.414 ms at 3.35 TB/s. erff (and expf) cost some 30-50 FP32
// instructions an element, not far below that, so each thread issues the
// loads of all its vectors before the math of the first.
// Design: 16-byte vector loads and stores (8 bf16 or 4 fp32); each 256-thread
// CTA takes 256 x U consecutive vectors, thread t the vectors t + 256 u
// (forward U = 4, backward U = 2: its two inputs make 4 loads in flight),
// one CTA for each such chunk; a scalar tail for n mod the vector width, and
// a scalar body where a pointer is not 16-byte aligned. On the H100 the
// chunked grid beat a grid-stride loop over the CTAs the SMs hold at once:
// 88.5% against 78.5-79.9% of the forward's bound, 90.6% against 77.9-81.4%
// of the backward's, and a plain copy 88.8% against 82.4-83.3% (torch's
// copy_ 89.0%).
#include <cstdint>

#include "warp_tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kFwdUnroll = 4;  // vectors a thread loads before it computes
constexpr int kBwdUnroll = 2;  // (of each input)
constexpr float kRsqrt2 = float(0.7071067811865476);    // the twin's 2 ** -0.5
constexpr float kErfScale = float(1.1283791670955126);  // autograd's 2 / sqrt(pi)

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

__device__ __forceinline__ float gelu_f(float h) {
  const float b = __fadd_rn(1.0f, erff(__fmul_rn(h, kRsqrt2)));
  return __fmul_rn(__fmul_rn(h, 0.5f), b);
}

// autograd's graph of the twin: u = h * c, b = 1 + erf(u), t = h * 0.5,
// g = t * b; backward: dt = dg * b, db = dg * t, du = (2/sqrt(pi) *
// exp(-(u * u))) * db, dh = du * c + dt * 0.5
__device__ __forceinline__ float gelu_grad_f(float h, float dg) {
  const float u = __fmul_rn(h, kRsqrt2);
  const float b = __fadd_rn(1.0f, erff(u));
  const float dt = __fmul_rn(dg, b);
  const float db = __fmul_rn(dg, __fmul_rn(h, 0.5f));
  const float du = __fmul_rn(__fmul_rn(kErfScale, expf(-__fmul_rn(u, u))), db);
  return __fadd_rn(__fmul_rn(du, kRsqrt2), __fmul_rn(dt, 0.5f));
}

// thread t of CTA c: vectors c * kThreads * U + t + kThreads * u, u < U
template <typename T, int V, int U>
__global__ void __launch_bounds__(kThreads)
gelu_fwd_kernel(const T* __restrict__ h, T* __restrict__ g, int64_t n) {
  using P = Pack<T, V>;
  const int64_t packs = n / V;
  const int64_t first = int64_t(blockIdx.x) * kThreads * U + threadIdx.x;
  P in[U];
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (first + u * kThreads < packs)
      in[u] = reinterpret_cast<const P*>(h)[first + u * kThreads];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (first + u * kThreads >= packs) continue;
    P out;
#pragma unroll
    for (int q = 0; q < V; ++q)
      out.v[q] = alpro::from_f32<T>(gelu_f(alpro::to_f32(in[u].v[q])));
    reinterpret_cast<P*>(g)[first + u * kThreads] = out;
  }
  const int64_t e = packs * V + first;  // the tail, one element a thread of CTA 0
  if (e < n) g[e] = alpro::from_f32<T>(gelu_f(alpro::to_f32(h[e])));
}

template <typename T, int V, int U>
__global__ void __launch_bounds__(kThreads)
gelu_bwd_kernel(const T* __restrict__ h, const T* __restrict__ dg, T* __restrict__ dh, int64_t n) {
  using P = Pack<T, V>;
  const int64_t packs = n / V;
  const int64_t first = int64_t(blockIdx.x) * kThreads * U + threadIdx.x;
  P hv[U], gv[U];
#pragma unroll
  for (int u = 0; u < U; ++u)
    if (first + u * kThreads < packs) {
      hv[u] = reinterpret_cast<const P*>(h)[first + u * kThreads];
      gv[u] = reinterpret_cast<const P*>(dg)[first + u * kThreads];
    }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    if (first + u * kThreads >= packs) continue;
    P out;
#pragma unroll
    for (int q = 0; q < V; ++q)
      out.v[q] = alpro::from_f32<T>(
          gelu_grad_f(alpro::to_f32(hv[u].v[q]), alpro::to_f32(gv[u].v[q])));
    reinterpret_cast<P*>(dh)[first + u * kThreads] = out;
  }
  const int64_t e = packs * V + first;
  if (e < n) dh[e] = alpro::from_f32<T>(gelu_grad_f(alpro::to_f32(h[e]), alpro::to_f32(dg[e])));
}

// one CTA for each kThreads * U vectors (at least one, for the tail)
unsigned grid(int64_t n, int vec, int unroll) {
  const int64_t per_cta = int64_t(kThreads) * unroll;
  const int64_t blocks = (n / vec + per_cta - 1) / per_cta;
  return unsigned(blocks < 1 ? 1 : blocks);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename T>
int fwd(const void* h, void* g, int64_t n, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T), U = kFwdUnroll;
  const T* hp = static_cast<const T*>(h);
  T* gp = static_cast<T*>(g);
  if (aligned16(h) && aligned16(g))
    gelu_fwd_kernel<T, V, U><<<grid(n, V, U), kThreads, 0, s>>>(hp, gp, n);
  else
    gelu_fwd_kernel<T, 1, U><<<grid(n, 1, U), kThreads, 0, s>>>(hp, gp, n);
  return int(cudaGetLastError());
}

template <typename T>
int bwd(const void* h, const void* dg, void* dh, int64_t n, cudaStream_t s) {
  constexpr int V = 16 / sizeof(T), U = kBwdUnroll;
  const T* hp = static_cast<const T*>(h);
  const T* gp = static_cast<const T*>(dg);
  T* dp = static_cast<T*>(dh);
  if (aligned16(h) && aligned16(dg) && aligned16(dh))
    gelu_bwd_kernel<T, V, U><<<grid(n, V, U), kThreads, 0, s>>>(hp, gp, dp, n);
  else
    gelu_bwd_kernel<T, 1, U><<<grid(n, 1, U), kThreads, 0, s>>>(hp, gp, dp, n);
  return int(cudaGetLastError());
}

}  // namespace

// h, g: n contiguous elements in bf16 (is_bf16) or fp32; n == 0 launches
// nothing. n / vector width / (256 * U) CTAs must fit the grid's x.
extern "C" int alpro_gelu_fwd(const void* h, void* g, int64_t n, int is_bf16, int device,
                              void* stream) {
  if (n < 0) return int(cudaErrorInvalidValue);
  if (n == 0) return int(cudaSuccess);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? fwd<__nv_bfloat16>(h, g, n, s) : fwd<float>(h, g, n, s);
}

// h, dg, dh: n contiguous elements, all bf16 (is_bf16) or all fp32.
extern "C" int alpro_gelu_bwd(const void* h, const void* dg, void* dh, int64_t n, int is_bf16,
                              int device, void* stream) {
  if (n < 0) return int(cudaErrorInvalidValue);
  if (n == 0) return int(cudaSuccess);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? bwd<__nv_bfloat16>(h, dg, dh, n, s) : bwd<float>(h, dg, dh, n, s);
}
