// Post-LN masked attention chain of a BERT layer:
//   out = LN(x + proj(softmax(q k^T * hd^-1/2 + (1 - mask) * -10000) v)),
//   q, k, v = x W^T + b per head, x (M, S, D), D = H * 64.
//
// Replaces the TPU kernel alpro_tpu/ops/pallas_bert_block.py::
// fused_bert_attention_block (_bert_attn_kernel). Its rounding points are
// the contract kept here:
//   * q, k and v get their bias in fp32, then round to the input dtype (q
//     and k for QK^T, v for PV; fp32 accumulation of both products);
//   * the scale is applied to the fp32 scores, the mask bias added in fp32,
//     the exact fp32 row max known before any p is rounded; the row sum l is
//     taken from the fp32 p, p rounds to the input dtype before PV, and the
//     division by l comes after PV, in fp32;
//   * the per-head output rounds to the weights' dtype before the output
//     projection, whose products over the heads are summed in fp32, plus the
//     bias and the fp32 residual, then LN with one-pass fp32 statistics and
//     one rounding.
// The TPU tiling (128-lane head windows, the cross-window sum carried in
// VMEM from one grid step to the next) does not bind. The weights come in
// torch Linear layout (out, in).
//
// What bounds it on an H100: at the fusion shape (M = 8, S = 237) it is
// 10.3 GFLOP (two thirds of it the q/k/v projections) against ~10.5 MB of
// activations and weights, so the tensor cores bound it (0.010 ms); one text
// query (M = 1, S = 40) is 0.19 GFLOP against 4.7 MB of weights, bound by
// bytes on paper and by latency in practice. bf16 runs as four launches
// behind one C call, every product on wgmma, from the port's Hopper parts:
//   1. gemm_wgmma.cuh, packed: [q | k | v] = x . [wq; wk; wv]^T + [bq | bk |
//      bv], the three weights through three tensor maps read in place (no
//      concatenation), each bias read in its dtype, rounded once into an
//      (M·S, 3D) bf16 scratch; one CTA per 128 x 128 tile, so x and the
//      weights are read from L2 per tile and K and V are projected once;
//   2. attn_wgmma.cuh with the key bias (B12/B13's instantiation): q, k and
//      v are 4-D tensor maps over the packed scratch (row stride 3D), the key
//      bias (1 - mask) * -10000 staged from the fp32 mask, one CTA per (head,
//      sequence) and its query tiles split over grid z where M·H CTAs would
//      leave the card idle; score rows in registers, one pass up to 256 keys,
//      two passes over streamed key chunks past that; o / l rounded into an
//      (M·S, D) bf16 heads scratch;
//   3. gemm_wgmma.cuh, kFloat: heads . wo^T in fp32 into partials (splits,
//      M·S, D), the K axis (the heads) cut into k_split-column slices where
//      the 128-row tiles would leave CTA slots free (ops/bert_block.py
//      proj_plan);
//   4. post_ln.cuh's finalize (K5's): the partials summed in slice order, +
//      bo + x in fp32, the row LN, one rounding.
// Shared memory bounds only the attention's key-bias row (20 480 keys on an
// H100): alpro_bert_attn_max_seq.
//
// fp32 (a test dtype: no tensor-core product keeps fp32 operands) keeps a
// CUDA-core body (warp_tile.cuh) in two launches:
//   1. bert_attn_heads: one block per (query-tile group, head, sequence).
//      It projects K and V of its head for the whole sequence (x streamed
//      through shared memory in 64 x 64 chunks with the weight chunks,
//      zero-filled past S) into shared memory, then for each of its 64-row
//      query tiles projects Q and runs the two softmax passes over 64-key
//      chunks (one warp per 16 query rows), and writes the per-head output
//      into an (M, S, D) scratch. The wrapper gives a sequence several
//      blocks (each its share of the query tiles) when M * H blocks would
//      leave SMs idle; each recomputes K and V.
//   2. bert_attn_proj_ln: the row-tile GEMM of row_tile.cuh (32 rows x all
//      D columns per block, fp32 accumulators in registers, 128 x 128 weight
//      tiles through shared memory) with the post-LN epilogue.
// Its largest S follows from shared memory (K and V of one head for the
// whole sequence).
#include "attn_wgmma.cuh"
#include "gemm_wgmma.cuh"
#include "post_ln.cuh"
#include "row_tile.cuh"

namespace {

using alpro::WarpTile;

constexpr int kHD = 64;   // head dim
constexpr int kQT = 64;   // query rows per tile, 16 per warp
constexpr int kAttnWarps = 4;
constexpr int kAttnThreads = kAttnWarps * 32;
constexpr int kKC = 64;   // depth chunk of the projections = key chunk of the softmax
constexpr int kRC = 64;   // rows per projection step, 16 per warp
constexpr int kLdSc = kKC + 4;  // fp32 score rows

template <typename T> __host__ __device__ constexpr int pad() { return 16 / int(sizeof(T)); }
template <typename T> __host__ __device__ constexpr int ldc() { return kKC + pad<T>(); }

template <typename T> __host__ __device__ constexpr size_t staging_bytes() {
  return size_t(kRC + 2 * kHD) * ldc<T>() * sizeof(T);
}
template <typename T> __host__ __device__ constexpr size_t warp_buf_bytes() {
  return size_t(16) * kLdSc * 4 + size_t(16) * ldc<T>() * sizeof(T);
}
template <typename T> size_t fixed_bytes() {
  return size_t(kQT) * (kHD + pad<T>()) * sizeof(T) +
         std::max(staging_bytes<T>(), kAttnWarps * warp_buf_bytes<T>());
}
template <typename T> size_t attn_smem(int SP, int ldkv) {
  return 2 * size_t(SP) * ldkv * sizeof(T) + fixed_bytes<T>();
}

// the largest S whose K and V fit (unpadded rows)
template <typename T> int max_seq(int device) {
  const long room = long(alpro::max_smem_optin(device)) - long(fixed_bytes<T>());
  if (room <= 0) return 0;
  return int(room / (2L * kHD * sizeof(T))) / 16 * 16;
}

// 64 rows x kKC columns of src (row stride lds) from column col0 into dst
// (leading dimension ldc<T>()); rows >= rows_valid are zero
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, long lds, int rows_valid,
                                           int col0) {
  constexpr int vpr = kKC * int(sizeof(T)) / 16;
  for (int i = threadIdx.x; i < 64 * vpr; i += kAttnThreads) {
    const int r = i / vpr, c = i % vpr;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < rows_valid) v = reinterpret_cast<const uint4*>(src + r * lds + col0)[c];
    reinterpret_cast<uint4*>(dst + r * ldc<T>())[c] = v;
  }
}

// acc (16 x 64, fp32) + bias[0..64) rounded to T into dst rows (ld ldd),
// through the warp's 16 x 16 fp32 scratch
template <typename T>
__device__ __forceinline__ void store_biased(WarpTile<T> (&acc)[kHD / 16], float* scr,
                                             const float* __restrict__ bias, T* dst, int ldd) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < kHD / 16; ++n) {
    acc[n].store(scr, 16);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int e = lane * 8 + j, r = e / 16, c = e % 16;
      dst[r * ldd + n * 16 + c] = alpro::from_f32<T>(scr[e] + bias[n * 16 + c]);
    }
    __syncwarp();
  }
}

// Projection of 64 rows of x (from row0; rows past S zero) through one or
// two heads' weight slices (64 x D each): warp w accumulates rows 16w..16w+15.
template <typename T, bool kTwo>
__device__ __forceinline__ void project(const T* __restrict__ xs_src, int rows_valid, int D,
                                        const T* __restrict__ wa, const T* __restrict__ wb,
                                        T* stage, WarpTile<T> (&acc_a)[kHD / 16],
                                        WarpTile<T> (&acc_b)[kHD / 16], bool active) {
  const int warp = threadIdx.x >> 5;
  T* xs = stage;
  T* sa = xs + kRC * ldc<T>();
  T* sb = sa + kHD * ldc<T>();
#pragma unroll
  for (int n = 0; n < kHD / 16; ++n) {
    acc_a[n].zero();
    acc_b[n].zero();
  }
  for (int kc = 0; kc < D; kc += kKC) {
    __syncthreads();  // every warp is done with the previous chunk
    stage_rows<T>(xs, xs_src, D, rows_valid, kc);
    stage_rows<T>(sa, wa, D, kHD, kc);
    if (kTwo) stage_rows<T>(sb, wb, D, kHD, kc);
    __syncthreads();
    if (!active) continue;
#pragma unroll
    for (int kk = 0; kk < kKC; kk += 16) {
#pragma unroll
      for (int n = 0; n < kHD / 16; ++n) {
        acc_a[n].template mma<true>(xs + warp * 16 * ldc<T>() + kk, ldc<T>(),
                                    sa + n * 16 * ldc<T>() + kk, ldc<T>());
        if (kTwo)
          acc_b[n].template mma<true>(xs + warp * 16 * ldc<T>() + kk, ldc<T>(),
                                      sb + n * 16 * ldc<T>() + kk, ldc<T>());
      }
    }
  }
  __syncthreads();  // the staging buffers are free (the warps' scratch aliases them)
}

// fp32 scores of the warp's 16 query rows against keys j0..j0+nk into sc
template <typename T>
__device__ __forceinline__ void scores(const T* qs, int ldq, const T* ks, int ldkv, int j0,
                                       int nk, float* sc) {
  for (int n = 0; n < nk / 16; ++n) {
    WarpTile<T> acc;
    acc.zero();
#pragma unroll
    for (int kk = 0; kk < kHD; kk += 16)
      acc.template mma<true>(qs + kk, ldq, ks + (j0 + n * 16) * ldkv + kk, ldkv);
    acc.store(sc + n * 16, kLdSc);
  }
  __syncwarp();
}

template <typename T>
__global__ void __launch_bounds__(kAttnThreads)
bert_attn_heads(const T* __restrict__ x, const float* __restrict__ mask,
                const T* __restrict__ wq, const float* __restrict__ bq,
                const T* __restrict__ wk, const float* __restrict__ bk,
                const T* __restrict__ wv, const float* __restrict__ bv,
                T* __restrict__ heads, int S, int SP, int H, int ldkv, float scale) {
  const int h = blockIdx.y, m = blockIdx.z;
  const int D = H * kHD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int ldq = kHD + pad<T>();

  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + SP * ldkv;
  T* Qs = Vs + SP * ldkv;
  unsigned char* U = reinterpret_cast<unsigned char*>(Qs + kQT * ldq);
  T* stage = reinterpret_cast<T*>(U);
  float* sc = reinterpret_cast<float*>(U + warp * warp_buf_bytes<T>());  // also the scratch
  T* pb = reinterpret_cast<T*>(sc + 16 * kLdSc);

  const T* xm = x + long(m) * S * D;
  const long woff = long(h) * kHD * D;  // this head's rows of W (out, in)
  WarpTile<T> acc_a[kHD / 16], acc_b[kHD / 16];

  // ---- K and V of head h for all SP rows ----
  for (int g0 = 0; g0 < SP; g0 += kRC) {
    const bool active = g0 + warp * 16 < S;
    project<T, true>(xm + long(g0) * D, S - g0, D, wk + woff, wv + woff, stage, acc_a, acc_b,
                     active);
    if (active) {
      store_biased<T>(acc_a, sc, bk + h * kHD, Ks + (g0 + warp * 16) * ldkv, ldkv);
      store_biased<T>(acc_b, sc, bv + h * kHD, Vs + (g0 + warp * 16) * ldkv, ldkv);
    }
  }

  const float* mrow = mask + long(m) * S;
  const int rr = lane >> 1, c0 = (lane & 1) * (kKC / 2);  // lane's row and columns of a chunk
  for (int q0 = blockIdx.x * kQT; q0 < S; q0 += gridDim.x * kQT) {
    const bool active = q0 + warp * 16 < S;
    // ---- Q of this tile ----
    project<T, false>(xm + long(q0) * D, S - q0, D, wq + woff, nullptr, stage, acc_a, acc_b,
                      active);
    if (active) {
      const T* qs = Qs + warp * 16 * ldq;
      store_biased<T>(acc_a, sc, bq + h * kHD, Qs + warp * 16 * ldq, ldq);
      // ---- pass 1: the row max of scale * s + mask bias over the S keys ----
      float mx = -INFINITY;
      for (int j0 = 0; j0 < SP; j0 += kKC) {
        const int nk = min(kKC, SP - j0);
        scores<T>(qs, ldq, Ks, ldkv, j0, nk, sc);
        for (int c = c0; c < c0 + kKC / 2; ++c) {
          const int key = j0 + c;
          if (c < nk && key < S)
            mx = fmaxf(mx, sc[rr * kLdSc + c] * scale + (1.0f - mrow[key]) * -10000.0f);
        }
        __syncwarp();
      }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      // ---- pass 2: p = exp(. - max), l from the fp32 p, o += p(T) . V ----
      float l = 0.0f;
      WarpTile<T> o[kHD / 16];
#pragma unroll
      for (int n = 0; n < kHD / 16; ++n) o[n].zero();
      for (int j0 = 0; j0 < SP; j0 += kKC) {
        const int nk = min(kKC, SP - j0);
        scores<T>(qs, ldq, Ks, ldkv, j0, nk, sc);
        for (int c = c0; c < c0 + kKC / 2; ++c) {
          const int key = j0 + c;
          float p = 0.0f;
          if (c < nk && key < S) {
            p = expf(sc[rr * kLdSc + c] * scale + (1.0f - mrow[key]) * -10000.0f - mx);
            l += p;
          }
          pb[rr * ldc<T>() + c] = alpro::from_f32<T>(p);
        }
        __syncwarp();
#pragma unroll
        for (int n = 0; n < kHD / 16; ++n)
          for (int kk = 0; kk < nk; kk += 16)
            o[n].template mma<false>(pb + kk, ldc<T>(), Vs + (j0 + kk) * ldkv + n * 16, ldkv);
        __syncwarp();
      }
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      // ---- o / l, rounded, into the per-head output ----
#pragma unroll
      for (int n = 0; n < kHD / 16; ++n) o[n].store(sc + n * 16, kLdSc);
      __syncwarp();
      const int row = q0 + warp * 16 + rr;
      if (row < S) {
        T* orow = heads + (long(m) * S + row) * D + h * kHD;
        for (int c = c0; c < c0 + kKC / 2; ++c)
          orow[c] = alpro::from_f32<T>(sc[rr * kLdSc + c] / l);
      }
    }
  }
}

// out = LN(heads . Wo^T + bo + x), rows of (R, D)
template <typename T, int NG>
__global__ void __launch_bounds__(alpro::rows::kThreads, 1)
bert_attn_proj_ln(const T* __restrict__ heads, const T* __restrict__ wo,
                  const float* __restrict__ bo, const T* __restrict__ x,
                  const float* __restrict__ ln_s, const float* __restrict__ ln_b,
                  T* __restrict__ out, int R, float eps) {
  using namespace alpro::rows;
  constexpr int D = NG * kTile;
  constexpr int ldo = D + vec<T>();
  const int r0 = blockIdx.x * kTM;

  extern __shared__ __align__(128) unsigned char smem[];
  T* ot = reinterpret_cast<T*>(smem);
  T* wt = ot + kTM * ldo;

  constexpr int vpr = D / vec<T>();
  for (int i = threadIdx.x; i < kTM * vpr; i += kThreads) {
    const int r = i / vpr, c = i % vpr;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + r < R) v = reinterpret_cast<const uint4*>(heads + long(r0 + r) * D)[c];
    reinterpret_cast<uint4*>(ot + r * ldo)[c] = v;
  }

  WarpTile<T> acc[NG];
#pragma unroll
  for (int g = 0; g < NG; ++g) acc[g].zero();
  // acc += heads . Wo^T; ends with a block sync, so the row tile and the
  // weight tile are free for the row buffer
  gemm<T, NG, true>(acc, ot, ldo, wo, D, NG, wt);
  post_ln_epilogue<T, NG>(acc, reinterpret_cast<float*>(smem), bo, x, ln_s, ln_b, out, r0, R,
                          eps);
}

template <typename T, int NG>
int launch_proj_ln(const void* heads, const void* wo, const void* bo, const void* x,
                   const void* ln_s, const void* ln_b, void* out, int R, float eps,
                   cudaStream_t stream) {
  using namespace alpro::rows;
  constexpr int D = NG * kTile;
  const size_t smem = std::max(size_t(kTM) * (D + vec<T>()) * sizeof(T) +
                                   size_t(kTile) * (kTile + vec<T>()) * sizeof(T),
                               ybuf_bytes(D));
  cudaError_t err = cudaFuncSetAttribute(bert_attn_proj_ln<T, NG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return int(err);
  bert_attn_proj_ln<T, NG><<<(R + kTM - 1) / kTM, kThreads, smem, stream>>>(
      static_cast<const T*>(heads), static_cast<const T*>(wo), static_cast<const float*>(bo),
      static_cast<const T*>(x), static_cast<const float*>(ln_s),
      static_cast<const float*>(ln_b), static_cast<T*>(out), R, eps);
  return int(cudaGetLastError());
}

template <typename T>
int launch_f32(const void* x, const void* mask, const void* wq, const void* bq, const void* wk,
               const void* bk, const void* wv, const void* bv, const void* wo, const void* bo,
               const void* ln_s, const void* ln_b, void* heads, void* out, int M, int S, int H,
               int q_split, float scale, float eps, int device, cudaStream_t stream) {
  const int SP = (S + 15) / 16 * 16;
  const int limit = alpro::max_smem_optin(device);
  int ldkv = kHD + pad<T>();  // padded rows against bank conflicts, where they fit
  if (attn_smem<T>(SP, ldkv) > size_t(limit)) ldkv = kHD;
  const size_t smem = attn_smem<T>(SP, ldkv);
  if (smem > size_t(limit)) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(bert_attn_heads<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return int(err);
  const int qtiles = (S + kQT - 1) / kQT;
  dim3 grid(std::min(q_split, qtiles), H, M);
  bert_attn_heads<T><<<grid, kAttnThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(mask), static_cast<const T*>(wq),
      static_cast<const float*>(bq), static_cast<const T*>(wk), static_cast<const float*>(bk),
      static_cast<const T*>(wv), static_cast<const float*>(bv), static_cast<T*>(heads), S, SP,
      H, ldkv, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const int R = M * S;
  switch (H * kHD) {
#define ALPRO_PROJ_LN_CASE(NG) \
  case NG * alpro::rows::kTile: \
    return launch_proj_ln<T, NG>(heads, wo, bo, x, ln_s, ln_b, out, R, eps, stream);
    ALPRO_PROJ_LN_CASE(2)
    ALPRO_PROJ_LN_CASE(4)
    ALPRO_PROJ_LN_CASE(6)
    ALPRO_PROJ_LN_CASE(8)
#undef ALPRO_PROJ_LN_CASE
    default: return int(cudaErrorInvalidValue);
  }
}

using bf16 = __nv_bfloat16;

// the bf16 attention plan's shared memory at S keys, with the key-bias row
// (0: no launch fits)
int plan_smem(int S, int optin) { return alpro::attn::plan_bf16<kHD>(S, optin, true).smem; }

// operand `part` (0 q, 1 k, 2 v) of the packed (M·S, 3D) scratch as the
// attention reads it: head_dim contiguous, the byte strides of the sequence,
// head and batch axes; an axis of extent 1 is never stepped and takes the
// view's byte span rounded up to 16 (ops/masked_attn.py::map_geometry)
alpro::attn::Operand packed_operand(const bf16* qkv, int part, int M, int S, int H) {
  const long long D = H * kHD, s_s = 3 * D, s_h = kHD, s_b = s_s * S;  // elements
  const long long span =
      (2 * (1 + (M - 1) * s_b + (H - 1) * s_h + (S - 1) * s_s + kHD - 1) + 15) / 16 * 16;
  auto stride = [&](long long st, int n) { return n > 1 ? 2 * st : span; };
  return {qkv + part * D, stride(s_s, S), stride(s_h, H), stride(s_b, M)};
}

// the four launches; TV: the biases' and LN vectors' dtype (bf16 or fp32)
template <typename TV>
int launch_bf16(const bf16* x, const float* mask, const bf16* wq, const TV* bq, const bf16* wk,
                const TV* bk, const bf16* wv, const TV* bv, const bf16* wo, const TV* bo,
                const TV* ln_s, const TV* ln_b, bf16* qkv, bf16* heads, float* partial,
                bf16* out, int M, int S, int H, int k_split, float scale, float eps, int device,
                cudaStream_t stream) {
  namespace gm = alpro::gemm;
  const int D = H * kHD, R = M * S;
  if (D > alpro::kFinThreads * alpro::kFinMaxPer || k_split < gm::kBK || k_split % gm::kBK ||
      !plan_smem(S, alpro::max_smem_optin(device)) || !qkv || !heads || !partial)
    return int(cudaErrorInvalidValue);
  const void* w[3] = {wq, wk, wv};
  const TV* b[3] = {bq, bk, bv};
  int err = gm::launch_packed<3, TV>(x, w, b, qkv, R, D, D, stream);
  if (err) return err;
  const alpro::attn::Strides so{static_cast<long long>(S) * D, D, kHD};
  err = alpro::attn::launch<kHD, false, true>(
      packed_operand(qkv, 0, M, S, H), packed_operand(qkv, 1, M, S, H),
      packed_operand(qkv, 2, M, S, H), heads, so, mask, nullptr, nullptr, M, H, S, S, scale, 1,
      device, stream);
  if (err) return err;
  const gm::Epilogue proj{{nullptr}, nullptr, 0, partial, nullptr, k_split};
  err = gm::launch<gm::kFloat>(heads, wo, proj, R, D, D, stream);
  if (err) return err;
  alpro::bert_mlp_finalize<bf16, TV><<<R, alpro::kFinThreads, 0, stream>>>(
      partial, (D + k_split - 1) / k_split, bo, x, ln_s, ln_b, out, R, D, eps);
  return int(cudaGetLastError());
}

}  // namespace

// The largest S the kernel takes for this dtype on this device: bf16 the
// attention plan's (its key-bias row in shared memory), fp32 K and V of one
// head for the whole sequence in shared memory.
extern "C" int alpro_bert_attn_max_seq(int is_bf16, int device) {
  if (!is_bf16) return max_seq<float>(device);
  const int optin = alpro::max_smem_optin(device);
  int s = 0;
  while (plan_smem(s + 1, optin)) ++s;
  return s;
}

// x, out: (M, S, H * 64) in one dtype; mask: fp32 (M, S), 1 = valid key;
// weights (out, in) in x's dtype. bf16: the biases and LN vectors all bf16
// (vec_bf16 1) or all fp32; scratch qkv (M·S, 3D) and heads (M·S, D) bf16,
// partial fp32 (ceil(D / k_split), M·S, D); k_split a multiple of 64. fp32:
// the vectors fp32, heads an (M, S, D) fp32 scratch, q_split blocks per
// (head, sequence) (at most the number of 64-row query tiles).
extern "C" int alpro_bert_attn(const void* x, const void* mask, const void* wq, const void* bq,
                               const void* wk, const void* bk, const void* wv, const void* bv,
                               const void* wo, const void* bo, const void* ln_s,
                               const void* ln_b, void* qkv, void* heads, void* partial, void* out,
                               int M, int S, int H, int q_split, int k_split, float scale,
                               float eps, int is_bf16, int vec_bf16, int device, void* stream) {
  if (M < 1 || S < 1 || H < 1) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m = static_cast<const float*>(mask);
  if (!is_bf16) {
    if (vec_bf16 || q_split < 1) return int(cudaErrorInvalidValue);
    return launch_f32<float>(x, mask, wq, bq, wk, bk, wv, bv, wo, bo, ln_s, ln_b, heads, out, M,
                             S, H, q_split, scale, eps, device, st);
  }
  auto w = [](const void* p) { return static_cast<const bf16*>(p); };
  bf16* o = static_cast<bf16*>(out);
  bf16* sq = static_cast<bf16*>(qkv);
  bf16* sh = static_cast<bf16*>(heads);
  float* sp = static_cast<float*>(partial);
  if (vec_bf16) {
    auto v = [](const void* p) { return static_cast<const bf16*>(p); };
    return launch_bf16<bf16>(w(x), m, w(wq), v(bq), w(wk), v(bk), w(wv), v(bv), w(wo), v(bo),
                             v(ln_s), v(ln_b), sq, sh, sp, o, M, S, H, k_split, scale, eps,
                             device, st);
  }
  auto v = [](const void* p) { return static_cast<const float*>(p); };
  return launch_bf16<float>(w(x), m, w(wq), v(bq), w(wk), v(bk), w(wv), v(bv), w(wo), v(bo),
                            v(ln_s), v(ln_b), sq, sh, sp, o, M, S, H, k_split, scale, eps, device,
                            st);
}
