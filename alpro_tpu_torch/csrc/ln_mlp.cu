// Fused row MLP over x (R, D), hidden Dh, in two placements of the LN:
//   pre-LN  (K3):  out = [x +] fc2(gelu(fc1(LN(x))))         TimeSformer tail
//   post-LN (K5):  out = LN(x + fc2(gelu(fc1(x))))           BERT MLP chain
//
// Replaces the TPU kernels alpro_tpu/ops/pallas_ln_mlp.py::fused_ln_mlp
// (_ln_mlp_kernel) and alpro_tpu/ops/pallas_bert_block.py::
// fused_bert_mlp_block (_bert_mlp_kernel). Contract kept from them: one-pass
// fp32 LN statistics (E[x^2] - E[x]^2, clamped at 0); fc1 on operands in the
// weights' dtype with fp32 accumulation, plus b1; GELU with the exact erf in
// fp32, rounded to the weights' dtype; fc2 the same, plus b2; the residual
// added in fp32; post-LN, the LN over the fp32 row, then one rounding. The
// weights come in torch Linear layout: w1 (Dh, D), w2 (D, Dh). The TPU
// kernels keep the (R, Dh) hidden on chip; that was their tiling's choice,
// not part of the contract.
//
// What bounds it on an H100: at the main shapes (K3: R = 12544, K5: R =
// 1896; D = 768, Dh = 3072) it is 4·R·D·Dh operations (118 and 18 GFLOP)
// against ~9.4 MB of bf16 weights and 4·R·D bytes of rows, so the tensor
// cores bound it. bf16 runs as up to four launches behind one C call, both
// products on wgmma (gemm_wgmma.cuh: TMA ring, one producer warp, two
// consumer warpgroups on 128 x 128 tiles, so a CTA re-reads the weights
// from L2 per 128 rows instead of the 32 of a row tile):
//   1. K3 only, ln_rows (ln_rows.cuh, shared with B9): xn = bf16(LN(x))
//      into an (R, D) scratch, one warp a row;
//   2. fc1, gemm_wgmma<kGelu>: g = bf16(gelu(xn · w1ᵀ + b1)) into an
//      (R, Dh) scratch;
//   3. fc2, gemm_wgmma<kFloat>: g · w2ᵀ over the hidden, which the wrapper
//      may cut into slices of h_split columns (grid y) where the 128-row
//      tiles would leave SMs idle (a text query's R = 40, the R = B CLS
//      rows). K3 with one slice adds b2 and the residual in fp32 and rounds
//      into out; otherwise each slice writes an fp32 partial (splits, R, D);
//   4. the finalize pass sums the partials in slice order, adds b2 and x
//      (and for K5 takes the row's LN), and rounds once.
// The hidden's round trip (2·R·Dh bf16 each way, 154 MB at K3's main shape)
// is ~0.05 ms at 3.35 TB/s, under a fifth of the products' time.
//
// fp32 keeps a CUDA-core body: one block of 16 warps per tile of 32 rows;
// the (LN'd, for pre-LN) tile (32 x D) sits in shared memory and the fp32
// 32 x D accumulator in registers (warp w owns rows 16*(w/8).., one 16x16
// output tile in each 128-column group; row_tile.cuh). The hidden is walked
// in chunks of 128:
//   fc1: h = xn . W1[chunk]^T over D/128 k-tiles (one 16x16 h tile per
//        warp), + b1, exact GELU into a small shared buffer;
//   fc2: acc += gelu(h) . W2[:, chunk]^T over D/128 output groups.
// Every weight tile (128 x 128) is read from device memory once per block
// with coalesced 16-byte loads, stored to shared memory and shared by all
// warps; the next tile is loaded into registers while the current one is
// multiplied. The post-LN epilogue stages the whole fp32 row tile in shared
// memory (aliasing the main loop's buffers) and applies LN per row. When
// there are fewer row tiles than SMs the hidden is split across blocks
// (grid.y) into fp32 partials, summed by the same finalize pass.
#include "gemm_wgmma.cuh"
#include "ln_rows.cuh"
#include "post_ln.cuh"
#include "row_tile.cuh"

namespace {

using alpro::bert_mlp_finalize;
using alpro::kFinMaxPer;
using alpro::kFinThreads;
using alpro::rows::kThreads;
using alpro::rows::kTile;
using alpro::rows::kTM;
using alpro::rows::kWarps;
using alpro::rows::tile_vecs;
using alpro::rows::vec;

template <typename T>
size_t smem_bytes(int D, bool post_ln) {
  const size_t main = size_t(kTM) * (D + vec<T>()) * sizeof(T)  // (LN'd) x tile
                      + size_t(kTM) * (kTile + vec<float>()) * 4  // fp32 fc1 chunk / epilogue
                      + size_t(kTM) * (kTile + vec<T>()) * sizeof(T)  // gelu chunk
                      + size_t(kTile) * (kTile + vec<T>()) * sizeof(T);  // weight tile
  // the post-LN row buffer aliases all of the above once the main loop is done
  return post_ln ? std::max(main, alpro::rows::ybuf_bytes(D)) : main;
}

// Stage s of a hidden chunk h0: s < NG is fc1 k-tile s (W1 rows h0.., columns
// 128*s..); s >= NG is fc2 output group g = s - NG (W2 rows 128*g..,
// columns h0..). Tile row r is weight row (hidden unit or output column).
template <typename T, int NG>
__device__ __forceinline__ void load_stage(uint4 (&buf)[tile_vecs<T>()], const T* w1,
                                           const T* w2, int D, int Dh, int h0, int s) {
  const T* src = s < NG ? w1 + long(h0) * D + s * kTile : w2 + long(s - NG) * kTile * Dh + h0;
  alpro::rows::load_tile<T>(buf, src, s < NG ? D : Dh);
}

template <typename T, int NG, bool kPostLN>  // NG = D / 128
__global__ void __launch_bounds__(kThreads, 1)
ln_mlp_kernel(const T* __restrict__ x, const float* __restrict__ ln_s,
              const float* __restrict__ ln_b, const T* __restrict__ w1,
              const float* __restrict__ b1, const T* __restrict__ w2,
              const float* __restrict__ b2, T* __restrict__ out,
              float* __restrict__ partial, int R, int Dh, int h_split, float eps,
              int residual) {
  constexpr int D = NG * kTile;
  constexpr int ldx = D + vec<T>(), ldh = kTile + vec<float>(), ldg = kTile + vec<T>();
  constexpr int ldw = kTile + vec<T>();
  const int r0 = blockIdx.x * kTM;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tr = warp / (kTile / 16), tc = warp % (kTile / 16);  // this warp's 16x16 tile

  extern __shared__ __align__(128) unsigned char smem[];
  T* xn = reinterpret_cast<T*>(smem);
  float* hb = reinterpret_cast<float*>(xn + kTM * ldx);
  T* gb = reinterpret_cast<T*>(hb + kTM * ldh);
  T* wt = gb + kTM * ldg;

  const int h_lo = blockIdx.y * h_split, h_hi = min(Dh, h_lo + h_split);
  uint4 buf[tile_vecs<T>()];
  load_stage<T, NG>(buf, w1, w2, D, Dh, h_lo, 0);  // in flight during the LN

  // ---- the x tile: LN'd (one warp per row, one-pass fp32 statistics) for
  //      pre-LN, as it is for post-LN ----
  for (int r = warp; r < kTM; r += kWarps) {
    const int row = r0 + r;
    T* xr = xn + r * ldx;
    if (row < R && kPostLN) {
      const T* src = x + long(row) * D;
      for (int c = lane * vec<T>(); c < D; c += 32 * vec<T>())
        *reinterpret_cast<uint4*>(xr + c) = *reinterpret_cast<const uint4*>(src + c);
    } else if (row < R) {
      const T* src = x + long(row) * D;
      float s = 0.0f, ss = 0.0f;
      for (int c = lane; c < D; c += 32) {
        const float v = alpro::to_f32(src[c]);
        s += v;
        ss = fmaf(v, v, ss);
      }
      s = alpro::warp_sum(s);
      ss = alpro::warp_sum(ss);
      const float mean = s / D;
      const float var = fmaxf(ss / D - mean * mean, 0.0f);
      const float rstd = rsqrtf(var + eps);
      for (int c = lane; c < D; c += 32)
        xr[c] = alpro::from_f32<T>((alpro::to_f32(src[c]) - mean) * rstd * ln_s[c] + ln_b[c]);
    } else {
      for (int c = lane; c < D; c += 32) xr[c] = alpro::from_f32<T>(0.0f);
    }
  }

  alpro::WarpTile<T> acc[NG];
#pragma unroll
  for (int g = 0; g < NG; ++g) acc[g].zero();

  for (int h0 = h_lo; h0 < h_hi; h0 += kTile) {
    alpro::WarpTile<T> h;
    h.zero();
#pragma unroll
    for (int s = 0; s < 2 * NG; ++s) {
      __syncthreads();  // every warp is done with the previous tile (and the LN)
      alpro::rows::store_tile<T>(buf, wt);
      __syncthreads();
      if (s + 1 < 2 * NG)
        load_stage<T, NG>(buf, w1, w2, D, Dh, h0, s + 1);
      else if (h0 + kTile < h_hi)
        load_stage<T, NG>(buf, w1, w2, D, Dh, h0 + kTile, 0);
      if (s < NG) {
        // fc1 k-tile s: h(tr, tc) += xn[rows, 128s..] . W1tile^T (col-major in wt)
#pragma unroll
        for (int kk = 0; kk < kTile; kk += 16)
          h.template mma<true>(xn + tr * 16 * ldx + s * kTile + kk, ldx,
                               wt + tc * 16 * ldw + kk, ldw);
        if (s == NG - 1) {
          h.store(hb + tr * 16 * ldh + tc * 16, ldh);
          __syncthreads();
          for (int i = threadIdx.x; i < kTM * kTile; i += kThreads) {
            const int r = i / kTile, j = i % kTile;
            const float v = hb[r * ldh + j] + b1[h0 + j];
            gb[r * ldg + j] =
                alpro::from_f32<T>(v * 0.5f * (1.0f + erff(v * 0.70710678118654752f)));
          }
        }
      } else {
        // fc2 group g: acc[g](tr, tc) += gelu(h)[rows, :] . W2tile^T
        const int g = s - NG;  // compile-time once the stage loop is unrolled
#pragma unroll
        for (int kk = 0; kk < kTile; kk += 16)
          acc[g].template mma<true>(gb + tr * 16 * ldg + kk, ldg, wt + tc * 16 * ldw + kk, ldw);
      }
    }
  }

  __syncthreads();  // every buffer of the main loop is free again
  if constexpr (kPostLN) {
    if (partial == nullptr) {
      alpro::rows::post_ln_epilogue<T, NG>(acc, reinterpret_cast<float*>(smem), b2, x, ln_s,
                                           ln_b, out, r0, R, eps);
      return;
    }
  }
  // ---- epilogue, one 16x16 tile at a time through a per-warp buffer:
  //      + b2, + residual in fp32, store; or the fp32 partial of this split ----
  float* stage = hb + warp * 256;
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    acc[g].store(stage, 16);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int e = lane * 8 + j, row = r0 + tr * 16 + e / 16;
      const int col = g * kTile + tc * 16 + e % 16;
      if (row < R) {
        const float a = stage[e];
        if (partial != nullptr) {
          partial[(long(blockIdx.y) * R + row) * D + col] = a;
        } else {
          float y = a + b2[col];
          if (residual) y += alpro::to_f32(x[long(row) * D + col]);
          out[long(row) * D + col] = alpro::from_f32<T>(y);
        }
      }
    }
    __syncwarp();
  }
}

// sum of the hidden splits' partials in split order, + b2, + residual
template <typename T>
__global__ void ln_mlp_finalize(const float* __restrict__ partial, int splits,
                                const float* __restrict__ b2, const T* __restrict__ x,
                                T* __restrict__ out, int R, int D, int residual) {
  const long i = long(blockIdx.x) * blockDim.x + threadIdx.x;
  const long n = long(R) * D;
  if (i >= n) return;
  float y = 0.0f;
  for (int s = 0; s < splits; ++s) y += partial[s * n + i];
  y += b2[i % D];
  if (residual) y += alpro::to_f32(x[i]);
  out[i] = alpro::from_f32<T>(y);
}

template <typename T, int NG, bool kPostLN>
int launch(const void* x, const void* s, const void* b, const void* w1, const void* b1,
           const void* w2, const void* b2, void* out, void* partial, int R, int Dh,
           int h_split, float eps, int residual, cudaStream_t stream) {
  constexpr int D = NG * kTile;
  static_assert(D <= kFinMaxPer * kFinThreads, "bert_mlp_finalize holds a row in registers");
  const size_t smem = smem_bytes<T>(D, kPostLN);
  cudaError_t err = cudaFuncSetAttribute(ln_mlp_kernel<T, NG, kPostLN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return int(err);
  const int splits = (Dh + h_split - 1) / h_split;
  dim3 grid((R + kTM - 1) / kTM, splits);
  ln_mlp_kernel<T, NG, kPostLN><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(s), static_cast<const float*>(b),
      static_cast<const T*>(w1), static_cast<const float*>(b1), static_cast<const T*>(w2),
      static_cast<const float*>(b2), static_cast<T*>(out),
      splits > 1 ? static_cast<float*>(partial) : nullptr, R, Dh, h_split, eps, residual);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return int(err);
  if constexpr (kPostLN) {
    bert_mlp_finalize<T><<<R, kFinThreads, 0, stream>>>(
        static_cast<const float*>(partial), splits, static_cast<const float*>(b2),
        static_cast<const T*>(x), static_cast<const float*>(s), static_cast<const float*>(b),
        static_cast<T*>(out), R, D, eps);
    return int(cudaGetLastError());
  }
  const long n = long(R) * D;
  ln_mlp_finalize<T><<<unsigned((n + 255) / 256), 256, 0, stream>>>(
      static_cast<const float*>(partial), splits, static_cast<const float*>(b2),
      static_cast<const T*>(x), static_cast<T*>(out), R, D, residual);
  return int(cudaGetLastError());
}

template <bool kPostLN>
int dispatch_f32(const void* x, const void* s, const void* b, const void* w1, const void* b1,
                 const void* w2, const void* b2, void* out, void* partial, int R, int D, int Dh,
                 int h_split, float eps, int residual, cudaStream_t st) {
  if (h_split % kTile != 0 || Dh % kTile != 0) return int(cudaErrorInvalidValue);
  switch (D) {
#define ALPRO_LN_MLP_CASE(NG)                                                              \
  case NG * kTile:                                                                        \
    return launch<float, NG, kPostLN>(x, s, b, w1, b1, w2, b2, out, partial, R, Dh,       \
                                      h_split, eps, residual, st);
    ALPRO_LN_MLP_CASE(2)
    ALPRO_LN_MLP_CASE(4)
    ALPRO_LN_MLP_CASE(6)
    ALPRO_LN_MLP_CASE(8)
#undef ALPRO_LN_MLP_CASE
    default: return int(cudaErrorInvalidValue);
  }
}

using bf16 = __nv_bfloat16;

// bf16: [ln_rows →] fc1 + GELU → fc2 (K slices of h_split) → [finalize].
// hidden: bf16 (R, Dh); normed: bf16 (R, D), pre-LN only; partial: fp32
// (ceil(Dh / h_split), R, D), unless pre-LN with h_split == Dh.
template <bool kPostLN>
int launch_bf16(const bf16* x, const float* s, const float* b, const bf16* w1,
                const float* b1, const bf16* w2, const float* b2, bf16* out, float* partial,
                bf16* hidden, bf16* normed, int R, int D, int Dh, int h_split, float eps,
                int residual, cudaStream_t stream) {
  namespace gm = alpro::gemm;
  const int splits = (Dh + h_split - 1) / h_split;
  const bool fused = !kPostLN && splits == 1;  // fc2 rounds straight into out
  if (D % 256 || D > 32 * 8 * alpro::kLnVecs || h_split % gm::kBK || hidden == nullptr ||
      (!kPostLN && normed == nullptr) || (!fused && partial == nullptr))
    return int(cudaErrorInvalidValue);
  const bf16* a = x;
  if (!kPostLN) {
    const int err = alpro::launch_ln_rows<float>(x, s, b, normed, R, D, eps, stream);
    if (err) return err;
    a = normed;
  }
  int err = gm::launch<gm::kGelu>(a, w1, gm::Epilogue{{hidden}, b1}, R, Dh, D, stream);
  if (err) return err;
  gm::Epilogue fc2{{out}, fused ? b2 : nullptr, 0, fused ? nullptr : partial,
                   fused && residual ? x : nullptr, h_split};
  err = gm::launch<gm::kFloat>(hidden, w2, fc2, R, D, Dh, stream);
  if (err || fused) return err;
  if constexpr (kPostLN) {
    bert_mlp_finalize<bf16><<<R, kFinThreads, 0, stream>>>(partial, splits, b2, x, s, b, out, R,
                                                           D, eps);
  } else {
    const long n = long(R) * D;
    ln_mlp_finalize<bf16><<<unsigned((n + 255) / 256), 256, 0, stream>>>(partial, splits, b2, x,
                                                                         out, R, D, residual);
  }
  return int(cudaGetLastError());
}

template <bool kPostLN>
int run(const void* x, const void* ln_s, const void* ln_b, const void* w1, const void* b1,
        const void* w2, const void* b2, void* out, void* partial, void* hidden, void* normed,
        int R, int D, int Dh, int h_split, float eps, int residual, int is_bf16, int device,
        void* stream) {
  if (R < 1 || h_split < 1 || Dh % kTile != 0) return int(cudaErrorInvalidValue);
  if (h_split < Dh && partial == nullptr) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_bf16)
    return dispatch_f32<kPostLN>(x, ln_s, ln_b, w1, b1, w2, b2, out, partial, R, D, Dh, h_split,
                                 eps, residual, st);
  return launch_bf16<kPostLN>(
      static_cast<const bf16*>(x), static_cast<const float*>(ln_s),
      static_cast<const float*>(ln_b), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<bf16*>(out), static_cast<float*>(partial),
      static_cast<bf16*>(hidden), static_cast<bf16*>(normed), R, D, Dh, h_split, eps, residual,
      st);
}

}  // namespace

// K3, pre-LN: out = [x +] fc2(gelu(fc1(LN(x)))). h_split: hidden columns per
// fp32 partial (fp32: a multiple of 128, per block; bf16: a multiple of 64,
// fc2's K slice). partial: fp32 (ceil(Dh / h_split), R, D), used when
// h_split < Dh. bf16 only: hidden (R, Dh) and normed (R, D) bf16 scratch.
extern "C" int alpro_ln_mlp(const void* x, const void* ln_s, const void* ln_b,
                            const void* w1, const void* b1, const void* w2, const void* b2,
                            void* out, void* partial, void* hidden, void* normed, int R, int D,
                            int Dh, int h_split, float eps, int residual, int is_bf16,
                            int device, void* stream) {
  return run<false>(x, ln_s, ln_b, w1, b1, w2, b2, out, partial, hidden, normed, R, D, Dh,
                    h_split, eps, residual, is_bf16, device, stream);
}

// K5, post-LN: out = LN(x + fc2(gelu(fc1(x)))); ln_s, ln_b are the closing
// LN's. As alpro_ln_mlp, with no normed scratch; bf16 always takes partial.
extern "C" int alpro_bert_mlp(const void* x, const void* w1, const void* b1, const void* w2,
                              const void* b2, const void* ln_s, const void* ln_b, void* out,
                              void* partial, void* hidden, int R, int D, int Dh, int h_split,
                              float eps, int is_bf16, int device, void* stream) {
  return run<true>(x, ln_s, ln_b, w1, b1, w2, b2, out, partial, hidden, nullptr, R, D, Dh,
                   h_split, eps, 1, is_bf16, device, stream);
}
