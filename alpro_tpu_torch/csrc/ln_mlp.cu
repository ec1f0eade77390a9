// Fused row MLP over x (R, D), hidden Dh, in two placements of the LN:
//   pre-LN  (K3):  out = [x +] fc2(gelu(fc1(LN(x))))         TimeSformer tail
//   post-LN (K5):  out = LN(x + fc2(gelu(fc1(x))))           BERT MLP chain
//
// Replaces the TPU kernels alpro_tpu/ops/pallas_ln_mlp.py::fused_ln_mlp
// (_ln_mlp_kernel) and alpro_tpu/ops/pallas_bert_block.py::
// fused_bert_mlp_block (_bert_mlp_kernel). Contract kept from them: one-pass
// fp32 LN statistics (E[x^2] - E[x]^2, clamped at 0); fc1 on operands in the
// weights' dtype with fp32 accumulation, plus b1; GELU with the exact erf in
// fp32; fc2 the same, plus b2; the residual added in fp32; the (R, Dh)
// hidden never written to device memory. The weights come in torch Linear
// layout: w1 (Dh, D), w2 (D, Dh).
//
// What bounds it on an H100: at the flagship (R = 3136, D = 768, Dh = 3072)
// it is 30 GFLOP against 4.8 MB of activations and 9.4 MB of bf16 weights, so
// the tensor cores bound it, provided the hidden stays on chip — which is the
// point of fusing. Design: one block of 16 warps per tile of 32 rows; the
// (LN'd, for pre-LN) tile (32 x D, input dtype) sits in shared memory and the
// fp32 32 x D accumulator in registers (warp w owns rows 16*(w/8).., one
// 16x16 output tile in each 128-column group; row_tile.cuh). The hidden is
// walked in chunks of 128:
//   fc1: h = xn . W1[chunk]^T over D/128 k-tiles (one 16x16 h tile per
//        warp), + b1, exact GELU into a small shared buffer;
//   fc2: acc += gelu(h) . W2[:, chunk]^T over D/128 output groups.
// Every weight tile (128 x 128) is read from device memory once per block
// with coalesced 16-byte loads, stored to shared memory and shared by all
// warps; the next tile is loaded into registers while the current one is
// multiplied. The post-LN epilogue stages the whole fp32 row tile in shared
// memory (aliasing the main loop's buffers) and applies LN per row. When
// there are fewer row tiles than SMs (the B cls rows, one text query) the
// hidden is split across blocks (grid.y): each writes its fp32 partial to a
// scratch buffer from the wrapper, and a second pass sums the partials in a
// fixed order, adds b2 and the residual (and, post-LN, applies the LN with
// one block per row). bf16 products run on the tensor cores (WMMA), fp32 on
// the CUDA cores (warp_tile.cuh).
#include "row_tile.cuh"

namespace {

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

// post-LN: the same sum, + b2 + x, then LN of the row; one block per row
constexpr int kFinThreads = 256;
constexpr int kFinMaxPer = 4;  // D <= 1024

template <typename T>
__global__ void __launch_bounds__(kFinThreads)
bert_mlp_finalize(const float* __restrict__ partial, int splits, const float* __restrict__ b2,
                  const T* __restrict__ x, const float* __restrict__ ln_s,
                  const float* __restrict__ ln_b, T* __restrict__ out, int R, int D,
                  float eps) {
  __shared__ float red[2][kFinThreads / 32];
  const int row = blockIdx.x, warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long n = long(R) * D, base = long(row) * D;
  float y[kFinMaxPer];
  float s = 0.0f, ss = 0.0f;
#pragma unroll
  for (int j = 0; j < kFinMaxPer; ++j) {
    const int c = threadIdx.x + j * kFinThreads;
    y[j] = 0.0f;
    if (c < D) {
      float v = 0.0f;
      for (int k = 0; k < splits; ++k) v += partial[k * n + base + c];
      v += b2[c] + alpro::to_f32(x[base + c]);
      y[j] = v;
      s += v;
      ss = fmaf(v, v, ss);
    }
  }
  s = alpro::warp_sum(s);
  ss = alpro::warp_sum(ss);
  if (lane == 0) {
    red[0][warp] = s;
    red[1][warp] = ss;
  }
  __syncthreads();
  s = ss = 0.0f;
#pragma unroll
  for (int w = 0; w < kFinThreads / 32; ++w) {
    s += red[0][w];
    ss += red[1][w];
  }
  const float mean = s / D;
  const float var = fmaxf(ss / D - mean * mean, 0.0f);
  const float rstd = rsqrtf(var + eps);
#pragma unroll
  for (int j = 0; j < kFinMaxPer; ++j) {
    const int c = threadIdx.x + j * kFinThreads;
    if (c < D) out[base + c] = alpro::from_f32<T>((y[j] - mean) * rstd * ln_s[c] + ln_b[c]);
  }
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

template <typename T, bool kPostLN>
int dispatch(const void* x, const void* s, const void* b, const void* w1, const void* b1,
             const void* w2, const void* b2, void* out, void* partial, int R, int D, int Dh,
             int h_split, float eps, int residual, cudaStream_t st) {
  switch (D) {
#define ALPRO_LN_MLP_CASE(NG)                                                               \
  case NG * kTile:                                                                           \
    return launch<T, NG, kPostLN>(x, s, b, w1, b1, w2, b2, out, partial, R, Dh, h_split, \
                                  eps, residual, st);
    ALPRO_LN_MLP_CASE(2)
    ALPRO_LN_MLP_CASE(4)
    ALPRO_LN_MLP_CASE(6)
    ALPRO_LN_MLP_CASE(8)
#undef ALPRO_LN_MLP_CASE
    default: return int(cudaErrorInvalidValue);
  }
}

template <bool kPostLN>
int run(const void* x, const void* ln_s, const void* ln_b, const void* w1, const void* b1,
        const void* w2, const void* b2, void* out, void* partial, int R, int D, int Dh,
        int h_split, float eps, int residual, int is_bf16, int device, void* stream) {
  if (h_split < 1 || h_split % kTile != 0 || Dh % kTile != 0) return int(cudaErrorInvalidValue);
  if (h_split < Dh && partial == nullptr) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch<__nv_bfloat16, kPostLN>(x, ln_s, ln_b, w1, b1, w2, b2, out,
                                                    partial, R, D, Dh, h_split, eps,
                                                    residual, st)
                 : dispatch<float, kPostLN>(x, ln_s, ln_b, w1, b1, w2, b2, out, partial, R,
                                            D, Dh, h_split, eps, residual, st);
}

}  // namespace

// K3, pre-LN: out = [x +] fc2(gelu(fc1(LN(x)))).
// partial: fp32 (ceil(Dh / h_split), R, D) scratch, used when h_split < Dh.
extern "C" int alpro_ln_mlp(const void* x, const void* ln_s, const void* ln_b,
                            const void* w1, const void* b1, const void* w2, const void* b2,
                            void* out, void* partial, int R, int D, int Dh, int h_split,
                            float eps, int residual, int is_bf16, int device, void* stream) {
  return run<false>(x, ln_s, ln_b, w1, b1, w2, b2, out, partial, R, D, Dh, h_split, eps,
                    residual, is_bf16, device, stream);
}

// K5, post-LN: out = LN(x + fc2(gelu(fc1(x)))); ln_s, ln_b are the closing LN's.
extern "C" int alpro_bert_mlp(const void* x, const void* w1, const void* b1, const void* w2,
                              const void* b2, const void* ln_s, const void* ln_b, void* out,
                              void* partial, int R, int D, int Dh, int h_split, float eps,
                              int is_bf16, int device, void* stream) {
  return run<true>(x, ln_s, ln_b, w1, b1, w2, b2, out, partial, R, D, Dh, h_split, eps, 1,
                   is_bf16, device, stream);
}
