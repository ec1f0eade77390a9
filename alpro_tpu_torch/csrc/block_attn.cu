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
// in and out, so it is bound by operations. A Hopper block cannot carry the
// projection's cross-head sum from one grid step to the next as the TPU grid
// does, so it runs as two launches, as qkv_proj.cu's B7 does:
//   1. block_attn_heads, one block of 4 warps per (query-tile group, head,
//      sample): the sample's k (fp32) and v (rounded) for the head projected
//      into shared memory (head_proj.cuh: 64 x 64 chunks of x and of the
//      head's weight rows, WMMA bf16 / fp32 CUDA-core tiles), then per 64-row
//      query tile the fp32 q projected the same way, a full fp32 score row
//      per query (one warp per 16 rows; the fp32 q . k^T on the CUDA cores),
//      the softmax, p rounded into a per-warp tile, p . v on the tensor cores
//      in bf16 (CUDA cores in fp32), and o / l rounded into an (B, S, D)
//      scratch;
//   2. proj_rows (row_tile.cuh): heads . Wp^T + b_proj over the rows, fp32
//      accumulators, rounded once.
// S is bounded by shared memory (fp32 K, rounded V and the score rows):
// alpro_block_attn_max_seq reports it.
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
                 const float* __restrict__ bqkv, const float* __restrict__ key_bias,
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

  for (int c = threadIdx.x; c < SP; c += kThreads)
    kb[c] = (c < S && key_bias != nullptr) ? key_bias[long(b) * S + c] : 0.0f;

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

template <typename T>
int launch(const void* x, const void* wqkv, const void* bqkv, const void* wproj,
           const void* bproj, const void* key_bias, void* heads, void* out, int B, int S, int H,
           int q_split, float scale, int device, cudaStream_t stream) {
  const int SP = (S + 15) / 16 * 16;
  const size_t smem = smem_bytes<T>(SP);
  if (smem > size_t(alpro::max_smem_optin(device))) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(block_attn_heads<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid(std::min(q_split, (S + kQT - 1) / kQT), H, B);
  block_attn_heads<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wqkv), static_cast<const float*>(bqkv),
      static_cast<const float*>(key_bias), static_cast<T*>(heads), S, SP, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  return alpro::rows::dispatch_proj<T>(H * kHD, heads, wproj, bproj, nullptr, out, B * S, stream);
}

}  // namespace

// The largest S the kernel takes for this dtype on this device.
extern "C" int alpro_block_attn_max_seq(int is_bf16, int device) {
  return is_bf16 ? max_seq<__nv_bfloat16>(device) : max_seq<float>(device);
}

// x, heads (scratch), out: (B, S, H * 64) in one dtype; wqkv (3D, D) and
// wproj (D, D) in it; bqkv, bproj fp32; key_bias fp32 (B, S) or null. Blocks
// per (head, sample): q_split (at most the number of 64-row query tiles).
extern "C" int alpro_block_attn(const void* x, const void* wqkv, const void* bqkv,
                                const void* wproj, const void* bproj, const void* key_bias,
                                void* heads, void* out, int B, int S, int H, int q_split,
                                float scale, int is_bf16, int device, void* stream) {
  if (B < 1 || S < 1 || H < 1 || q_split < 1) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(x, wqkv, bqkv, wproj, bproj, key_bias, heads, out, B,
                                         S, H, q_split, scale, device, st)
                 : launch<float>(x, wqkv, bqkv, wproj, bproj, key_bias, heads, out, B, S, H,
                                 q_split, scale, device, st);
}
