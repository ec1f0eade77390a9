// The whole attention sublayer of a ViT block, before the residual:
//   out = proj(softmax(q k^T * scale + key_bias) v) + b_proj,
//   q, k, v = x . W_h^T + b_h per head,  x (B, S, D), D = H * 64.
//
// Replaces the TPU kernel alpro_tpu/ops/pallas_block_attn.py::
// fused_attention_block (_kernel). Its rounding points are the contract kept
// here, its tiling (one grid step per sample, every head unrolled, the
// weights resident in VMEM) is not:
//   * q, k, v per head are x . W_h with operands in x's dtype, fp32
//     accumulation and the fp32 bias; they are never rounded;
//   * s = q . k^T * scale + key bias, in fp32 (the key bias is the HF
//     (1 - mask) * -10000 in fp32, or 0); keys past S take no part;
//   * p = exp(s - max) is rounded to x's dtype, v is rounded to x's dtype,
//     p . v accumulates in fp32 and is divided by l, the fp32 sum of the
//     unrounded p;
//   * o is rounded to x's dtype; o . Wp is summed over the heads in fp32,
//     plus the fp32 b_proj, and rounded once.
// Weights come in torch Linear layout (out, in) in x's dtype; biases fp32.
//
// What bounds it on an H100: at one add_videos call's spatial sublayer (64
// frames of 197 tokens, D = 768, 12 heads) it is 44.6 GFLOP of q/k/v
// projection, 7.6 of attention and 14.9 of output projection against ~44 MB
// in and out, so it is bound by operations (0.068 ms at 989 TFLOP/s). A
// Hopper CTA per (sample, head) that projected its own q, k and v would
// re-read x and the head's weights from L2 per row tile (~0.9 GB at that
// shape) or hold more fp32 accumulators than an SM has registers, and a
// CTA cannot carry the projection's cross-head sum from one grid step to the
// next as the TPU grid does. So bf16 runs as three launches, every product
// on wgmma:
//   1. gemm_wgmma.cuh: [q | k | v] = x · wqkvᵀ + bqkv over the B·S rows
//      (TMA ring, two consumer warpgroups), written as five (B, S, D) bf16
//      scratch tensors: q and k as hi + lo pairs (fp32 to ~2^-16: q and k
//      are never rounded at the contract's 2^-8), v rounded;
//   2. attn_wgmma.cuh under kSplit (K1's body, one CTA per (head, sample)):
//      s = q_hi·k_hiᵀ + q_hi·k_loᵀ + q_lo·k_hiᵀ in fp32, times the scale,
//      plus the key bias staged from the key mask (kBias), the exact row max
//      in registers, p rounded for P·V, o / l rounded into a (B, S, D)
//      heads scratch;
//   3. gemm_wgmma.cuh again: heads · wprojᵀ + bproj, fp32 over all D
//      columns (the contract's head sum in another order), rounded once.
// The round trip through the scratch writes 6 · B·S·D bf16 and reads it
// back (~116 MB each way at the main shape, ~0.07 ms at 3.35 TB/s). The
// attention's plan (a ring of two slots of three K panels past 256 keys, and
// the key-bias row) bounds S: alpro_block_attn_max_seq.
//
// fp32 keeps a CUDA-core body (no tensor-core product keeps fp32 operands):
//   1. block_attn_heads, one block of 4 warps per (query-tile group, head,
//      sample): the sample's fp32 k and v for the head projected into shared
//      memory (head_proj.cuh), then per 64-row query tile the fp32 q, a full
//      fp32 score row per query (one warp per 16 rows), the softmax, p . v,
//      and o / l into an (B, S, D) scratch;
//   2. proj_rows (row_tile.cuh): heads . Wp^T + b_proj over the rows.
// S is bounded by shared memory (fp32 K, V and the score rows).
#include "attn_wgmma.cuh"
#include "gemm_wgmma.cuh"
#include "head_proj.cuh"
#include "row_tile.cuh"

namespace {

using alpro::WarpTile;
using alpro::heads::kHD;
using alpro::heads::kRC;
using alpro::heads::kThreads;
using alpro::heads::kWarps;
using alpro::heads::pad;
using alpro::heads::project;
using alpro::heads::staging_bytes;
using alpro::heads::store_biased;

constexpr int kQT = kWarps * 16;  // query rows per tile, 16 per warp
constexpr int kLdF = kHD + 4;     // fp32 q and k rows
template <typename T> __host__ __device__ constexpr int ldv() { return kHD + pad<T>(); }

// per warp: 16 fp32 score rows (leading dimension SP + 4), a 16 x 16 fp32
// scratch, 16 row sums, 16 rows of p in T (leading dimension SP + pad)
template <typename T> __host__ __device__ size_t warp_bytes(int SP) {
  return size_t(16) * (SP + 4) * 4 + 256 * 4 + 16 * 4 + size_t(16) * (SP + pad<T>()) * sizeof(T);
}

template <typename T> size_t smem_bytes(int SP) {
  return size_t(SP) * kLdF * 4             // fp32 K
         + size_t(kQT) * kLdF * 4          // fp32 Q tile
         + size_t(SP) * ldv<T>() * sizeof(T)  // rounded V
         + size_t(SP) * 4                  // key bias
         + std::max(staging_bytes<T>(2), size_t(kWarps) * warp_bytes<T>(SP));
}

// the largest S whose K, V and score rows fit
template <typename T> int max_seq(int device) {
  const size_t limit = size_t(alpro::max_smem_optin(device));
  int s = 0;
  while (smem_bytes<T>(s + 16) <= limit) s += 16;
  return s;
}

// One warp: its 16 query rows qs (fp32, unscaled) against the keys Ks (fp32)
// and values Vs (T); o / l rounded into row r of dst for r < nrows.
template <typename T>
__device__ __forceinline__ void attend(const float* qs, const float* Ks, const T* Vs,
                                       const float* kb, int S, int SP, float scale,
                                       unsigned char* wbuf, T* __restrict__ dst, long ldd,
                                       int nrows) {
  const int lane = threadIdx.x & 31;
  const int ldsc = SP + 4, ldp = SP + pad<T>();
  constexpr int lv = ldv<T>();
  float* sc = reinterpret_cast<float*>(wbuf);
  float* scr = sc + 16 * ldsc;  // 32-byte aligned
  float* lrow = scr + 256;
  T* P = reinterpret_cast<T*>(lrow + 16);
  // ---- scores: (16 x 64) . (64 x SP), fp32 ----
  for (int j = 0; j < SP / 16; ++j) {
    WarpTile<float> acc;
    acc.zero();
#pragma unroll
    for (int kk = 0; kk < kHD; kk += 16)
      acc.template mma<true>(qs + kk, kLdF, Ks + j * 16 * kLdF + kk, kLdF);
    acc.store(sc + j * 16, ldsc);
  }
  __syncwarp();
  // ---- s * scale + key bias, fp32 max, p = exp(s - max) rounded, l ----
  for (int r = 0; r < 16; ++r) {
    float* srow = sc + r * ldsc;
    float mx = -INFINITY;
    for (int c = lane; c < S; c += 32) {
      const float s = srow[c] * scale + kb[c];
      srow[c] = s;
      mx = fmaxf(mx, s);
    }
    mx = alpro::warp_max(mx);
    float l = 0.0f;
    for (int c = lane; c < SP; c += 32) {
      const float p = c < S ? expf(srow[c] - mx) : 0.0f;
      P[r * ldp + c] = alpro::from_f32<T>(p);
      l += p;
    }
    l = alpro::warp_sum(l);
    if (lane == 0) lrow[r] = l;
  }
  __syncwarp();
  // ---- o = p . v: (16 x SP) . (SP x 64) in T, fp32 accumulation ----
  WarpTile<T> o[kHD / 16];
#pragma unroll
  for (int n = 0; n < kHD / 16; ++n) o[n].zero();
  for (int j = 0; j < SP / 16; ++j)
#pragma unroll
    for (int n = 0; n < kHD / 16; ++n)
      o[n].template mma<false>(P + j * 16, ldp, Vs + j * 16 * lv + n * 16, lv);
#pragma unroll
  for (int n = 0; n < kHD / 16; ++n) {
    o[n].store(scr, 16);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = lane * 8 + i, r = e / 16, c = e % 16;
      if (r < nrows) dst[r * ldd + n * 16 + c] = alpro::from_f32<T>(scr[e] / lrow[r]);
    }
    __syncwarp();
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
block_attn_heads(const T* __restrict__ x, const T* __restrict__ wqkv,
                 const float* __restrict__ bqkv, const float* __restrict__ mask,
                 T* __restrict__ heads, int S, int SP, int H, float scale) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int D = H * kHD;
  const int warp = threadIdx.x >> 5;
  constexpr int lv = ldv<T>();

  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Qs = Ks + SP * kLdF;
  T* Vs = reinterpret_cast<T*>(Qs + kQT * kLdF);
  float* kb = reinterpret_cast<float*>(Vs + SP * lv);
  unsigned char* rest = reinterpret_cast<unsigned char*>(kb + SP);
  T* stage = reinterpret_cast<T*>(rest);  // the staging area, then the warps' buffers
  unsigned char* wbuf = rest + warp * warp_bytes<T>(SP);
  float* scr = reinterpret_cast<float*>(wbuf) + 16 * (SP + 4);

  for (int c = threadIdx.x; c < SP; c += kThreads)  // the twin's key_bias, in its fp32 steps
    kb[c] = (c < S && mask != nullptr) ? (1.0f - mask[long(b) * S + c]) * -10000.0f : 0.0f;

  const T* xb = x + long(b) * S * D;
  auto row_ptr = [&](int r) -> const T* { return r < S ? xb + long(r) * D : nullptr; };

  // ---- k (fp32) and v (rounded) of head h for all SP rows ----
  const T* wkv[2] = {wqkv + long(D + h * kHD) * D, wqkv + long(2 * D + h * kHD) * D};
  WarpTile<T> kv[2][kHD / 16];
  for (int g0 = 0; g0 < SP; g0 += kRC) {
    const bool active = g0 + warp * 16 < SP;
    project<T, 2, false>(row_ptr, g0, nullptr, nullptr, nullptr, nullptr, D, wkv, stage, kv,
                         active);
    if (active) {
      store_biased<float>(kv[0], scr, bqkv + D + h * kHD, Ks + (g0 + warp * 16) * kLdF, kLdF,
                          1.0f);
      store_biased<T>(kv[1], scr, bqkv + 2 * D + h * kHD, Vs + (g0 + warp * 16) * lv, lv, 1.0f);
    }
  }

  const T* wq[1] = {wqkv + long(h) * kHD * D};
  for (int q0 = blockIdx.x * kQT; q0 < S; q0 += gridDim.x * kQT) {
    const bool active = q0 + warp * 16 < S;
    WarpTile<T> qa[1][kHD / 16];
    project<T, 1, false>(row_ptr, q0, nullptr, nullptr, nullptr, nullptr, D, wq, stage, qa,
                         active);
    if (!active) continue;  // no block sync follows before the next project
    float* qs = Qs + warp * 16 * kLdF;
    store_biased<float>(qa[0], scr, bqkv + h * kHD, qs, kLdF, 1.0f);
    attend<T>(qs, Ks, Vs, kb, S, SP, scale, wbuf,
              heads + (long(b) * S + q0 + warp * 16) * D + h * kHD, D, S - q0 - warp * 16);
  }
}

constexpr int kHeadsBf16 = 64;  // head_dim of the bf16 route

// the bf16 route's attention plan at S keys (with the key-bias row)
int plan_smem(int S, int smem_optin) {
  return alpro::attn::plan_bf16<kHeadsBf16>(S, smem_optin, true, true).smem;
}

int launch_f32(const float* x, const float* wqkv, const float* bqkv, const float* wproj,
               const float* bproj, const float* mask, float* heads, float* out, int B, int S,
               int H, int q_split, float scale, int device, cudaStream_t stream) {
  const int SP = (S + 15) / 16 * 16;
  const size_t smem = smem_bytes<float>(SP);
  if (smem > size_t(alpro::max_smem_optin(device))) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(block_attn_heads<float>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid(std::min(q_split, (S + kQT - 1) / kQT), H, B);
  block_attn_heads<float><<<grid, kThreads, smem, stream>>>(x, wqkv, bqkv, mask, heads, S, SP,
                                                            H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  return alpro::rows::dispatch_proj<float>(H * kHD, heads, wproj, bproj, nullptr, out, B * S,
                                           stream);
}

// scratch: six (B, S, D) bf16 tensors, q_hi, q_lo, k_hi, k_lo, v, heads
int launch_bf16(const __nv_bfloat16* x, const __nv_bfloat16* wqkv, const float* bqkv,
                const __nv_bfloat16* wproj, const float* bproj, const float* mask,
                __nv_bfloat16* scratch, __nv_bfloat16* out, int B, int S, int H, float scale,
                int device, cudaStream_t stream) {
  using alpro::attn::Operand;
  const int D = H * kHeadsBf16, M = B * S;
  if (!plan_smem(S, alpro::max_smem_optin(device))) return int(cudaErrorInvalidValue);
  __nv_bfloat16* part[6];
  for (int i = 0; i < 6; ++i) part[i] = scratch + long(i) * M * D;
  const alpro::gemm::Epilogue qkv{{part[0], part[1], part[2], part[3], part[4]}, bqkv, D};
  int err = alpro::gemm::launch(x, wqkv, qkv, M, 3 * D, D, stream);
  if (err) return err;
  // each operand (B, S, H, 64): byte strides of the sequence, head and batch
  auto operand = [&](int i) {
    return Operand{part[i], 2LL * D, 2LL * kHeadsBf16, 2LL * S * D};
  };
  const Operand q = operand(0), k = operand(2), v = operand(4), lo[2] = {operand(1), operand(3)};
  const alpro::attn::Strides so{static_cast<long long>(S) * D, D, kHeadsBf16};
  err = mask ? alpro::attn::launch<kHeadsBf16, false, true, true>(
                   q, k, v, part[5], so, mask, nullptr, nullptr, B, H, S, S, scale, 1, device,
                   stream, lo)
             : alpro::attn::launch<kHeadsBf16, false, false, true>(
                   q, k, v, part[5], so, nullptr, nullptr, nullptr, B, H, S, S, scale, 1, device,
                   stream, lo);
  if (err) return err;
  const alpro::gemm::Epilogue proj{{out}, bproj, 0};
  return alpro::gemm::launch(part[5], wproj, proj, M, D, D, stream);
}

}  // namespace

// The largest S the kernel takes for this dtype on this device.
extern "C" int alpro_block_attn_max_seq(int is_bf16, int device) {
  if (!is_bf16) return max_seq<float>(device);
  const int optin = alpro::max_smem_optin(device);
  int s = 0;
  while (plan_smem(s + 1, optin)) ++s;
  return s;
}

// x, out: (B, S, H * 64) in one dtype; wqkv (3D, D) and wproj (D, D) in it;
// bqkv, bproj fp32; mask fp32 (B, S) key mask (1: a valid key) or null.
// scratch: bf16 six (B, S, D) tensors, fp32 one. q_split: fp32 blocks per
// (head, sample) (at most the number of 64-row query tiles).
extern "C" int alpro_block_attn(const void* x, const void* wqkv, const void* bqkv,
                                const void* wproj, const void* bproj, const void* mask,
                                void* scratch, void* out, int B, int S, int H, int q_split,
                                float scale, int is_bf16, int device, void* stream) {
  if (B < 1 || S < 1 || H < 1 || q_split < 1) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  if (is_bf16)
    return launch_bf16(static_cast<const __nv_bfloat16*>(x),
                       static_cast<const __nv_bfloat16*>(wqkv), static_cast<const float*>(bqkv),
                       static_cast<const __nv_bfloat16*>(wproj),
                       static_cast<const float*>(bproj), m,
                       static_cast<__nv_bfloat16*>(scratch), static_cast<__nv_bfloat16*>(out),
                       B, S, H, scale, device, st);
  return launch_f32(static_cast<const float*>(x), static_cast<const float*>(wqkv),
                    static_cast<const float*>(bqkv), static_cast<const float*>(wproj),
                    static_cast<const float*>(bproj), m, static_cast<float*>(scratch),
                    static_cast<float*>(out), B, S, H, q_split, scale, device, st);
}

// y = a (M, K) · w (N, K)ᵀ + bias (N, fp32), bf16 a, w and outputs. split 0:
// out[0] (M, N); split D (N = 3D): out[0..4] q_hi, q_lo, k_hi, k_lo, v, each
// (M, D). N and D multiples of 128, K of 64. B17's GEMM alone.
extern "C" int alpro_gemm_bf16(const void* a, const void* w, const void* bias,
                               void* const* out, int M, int N, int K, int split, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  alpro::gemm::Epilogue ep{{}, static_cast<const float*>(bias), split};
  for (int i = 0; i < (split ? 5 : 1); ++i) ep.out[i] = static_cast<__nv_bfloat16*>(out[i]);
  return alpro::gemm::launch(a, w, ep, M, N, K, static_cast<cudaStream_t>(stream));
}
