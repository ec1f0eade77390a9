// A bf16 GEMM on Hopper: y = a · wᵀ (+ bias), fp32 accumulation, for B17's
// two projections (csrc/block_attn.cu), the two products of the MLP kernels
// K3 and K5 (csrc/ln_mlp.cu), K4's two projections (csrc/bert_attn.cu),
// B9's and B7's (csrc/fused_block.cu, csrc/qkv_proj.cu) and B15's patch
// embedding (csrc/patchify_embed.cu).
//
// a (M, K) and w (N, K) are row-major bf16 (w in torch Linear layout, so
// both are K-major, as wgmma takes them from shared memory); bias (N) fp32,
// or (TV = bf16: B9, B7) the layer's bf16 vector widened on load.
// gemm_wgmma_kn (kRound only: B15) takes w as a (K, N) row-major matrix
// instead, read in place as an MN-major operand: each stage holds it as two
// panels of 64 K-rows x 64 columns (128-byte swizzle), one TMA box each,
// which wgmma reads through MN-major descriptors, as attn_wgmma.cuh reads V.
// The epilogue mode (kMode) says what becomes of the fp32 sums:
//   kRound: y + bias rounded to bf16 into one (M, N) output, or (split D,
//     N = 3D: a packed [q | k | v] projection) into five (M, D) bf16
//     outputs: q and k as a pair hi = bf16(y), lo = bf16(y - hi), so
//     hi + lo keeps y to about 2^-16 of |y|, and v rounded once (B17); or,
//     where a sixth output is given, six: v as a hi + lo pair too (B9);
//   kGelu: gelu(y + bias) with the exact erf in fp32, rounded to bf16 into
//     one (M, N) output (fc1 of K3/K5);
//   kFloat: y (+ bias where given) in fp32, either stored as fp32 into
//     split-K partial grid.y of an fp32 (splits, M, N) buffer, or, plus an
//     optional bf16 residual (M, N) added in fp32, rounded once into a bf16
//     (M, N) output (fc2 of K3/K5).
// Grid y splits K into slices of ep.k_split columns (kFloat with partials
// only); every other launch has one slice. kSegs > 1 (kRound, K4's packed
// [q | k | v]): w is kSegs separate (N / kSegs, K) matrices, each through
// its own tensor map and with its own bias (fp32 or bf16, widened on load),
// read in place; y goes to one (M, N) output.
//
// What bounds it on an H100: at B17's shapes (M = 12608 rows, K = 768, N =
// 2304 or 768) 2·M·N·K operations over (M + N)·K inputs and M·N outputs,
// ~295 operations per byte at 989 TFLOP/s and 3.35 TB/s: the tensor cores
// bound the qkv product, and the split outputs (5 · M · D bf16) come close;
// the MLP's products (K = 768 or 3072, N = 3072 or 768) are bound by the
// tensor cores at every R past a few hundred rows.
// Design: one CTA per kBM x kBN output tile (and K slice), in a grid with
// the column tiles fastest, so the CTAs in flight share their rows of a in
// L2 (w stays there whole). One producer warp keeps kStages 64-wide
// K-chunks of a and w in flight by TMA (128-byte swizzle, one mbarrier per
// stage for "full" and one for "empty"); two consumer warpgroups each take
// 64 rows of the tile and run m64 x kBN x 16 wgmma with A and B from shared
// memory into fp32 registers, one stage's products in flight behind the
// next's. The epilogue stages the tile (bf16, or fp32 for kFloat) in the
// freed stage memory and writes it out in coalesced 16-byte chunks.
// kMinBlocks CTAs share an SM, so one CTA's epilogue overlaps another's
// products. Rows past M are zero-filled by TMA and not stored.
#pragma once

#include "hopper.cuh"
#include "warp_tile.cuh"

namespace alpro {
namespace gemm {
namespace {

using bf16 = __nv_bfloat16;
namespace hp = alpro::hopper;

constexpr int kBM = 128;                   // rows of a tile: two warpgroups of 64
constexpr int kBN = 128;                   // columns of a tile
constexpr int kBK = 64;                    // K per stage: one 128-byte panel row
constexpr int kStages = 3;
constexpr int kMinBlocks = 2;              // CTAs an SM holds at once
constexpr int kConsumers = 256;            // two warpgroups
constexpr int kThreads = kConsumers + 32;  // and the producer warp
constexpr int kABytes = kBM * kBK * 2;
constexpr int kBBytes = kBN * kBK * 2;
constexpr int kStageBytes = kABytes + kBBytes;
constexpr int kOutBytes = kBM * kBN * 2;   // one bf16 output tile, staged
static_assert(2 * kOutBytes <= kStages * kStageBytes, "hi and lo tiles, or an fp32 tile, fit");
// 1024 alignment slack, the stages, the 2 x kStages barriers
constexpr int kSmem = 1024 + kStages * kStageBytes + 2 * kStages * 8;

// epilogue modes (the kernel's template argument)
constexpr int kRound = 0, kGelu = 1, kFloat = 2;

// Where y goes. kRound, split == 0, and kGelu: out[0] is (M, N). kRound,
// split == D: N = 3D, out[0..4] are q_hi, q_lo, k_hi, k_lo, v (v_hi), each
// (M, D), and out[5], where not null, v_lo. kFloat: partial (splits, M, N)
// fp32 where not null, else out[0] (M, N) bf16 with the residual (M, N)
// bf16 added where not null. bias: N values of the kernel's TV (kSegs 1).
// k_split: K columns per slice of grid y (0: all of K).
struct Epilogue {
  bf16* out[6];
  const void* bias;
  int split;
  float* partial;
  const bf16* residual;
  int k_split;
};

// kSegs > 1: the maps of weight segments 1 .. kSegs - 1 (segment 0 is the
// kernel's mw) and every segment's bias, in TV
template <int kSegs, typename TV> struct Segments {
  CUtensorMap w[kSegs - 1];
  const TV* bias[kSegs];
};
template <typename TV> struct Segments<1, TV> {};

__device__ __forceinline__ float gelu_erf(float v) {
  return v * 0.5f * (1.0f + erff(v * 0.70710678118654752f));
}

// One CTA's tile: the body of gemm_wgmma (kWKN false: w (N, K)) and of
// gemm_wgmma_kn (kWKN true: w (K, N)); the maps and ep are the kernel's
// __grid_constant__ parameters, so TMA reads the maps where they lie.
template <int kMode, int kSegs, typename TV, bool kWKN>
__device__ __forceinline__ void gemm_tile(const CUtensorMap& ma, const CUtensorMap& mw,
                                          const Epilogue& ep, int M, int N, int K,
                                          const Segments<kSegs, TV>& segs) {
  static_assert(kSegs == 1 || kMode == kRound, "segments are a kRound launch's");
  static_assert(!kWKN || (kMode == kRound && kSegs == 1), "a (K, N) w is B15's kRound");
  const TV* bias = static_cast<const TV*>(ep.bias);  // kSegs 1
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(base + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  const int ntn = N / kBN;
  const int n0 = (blockIdx.x % ntn) * kBN, m0 = (blockIdx.x / ntn) * kBM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // this CTA's weight rows: segment sg's rows from wrow (kSegs 1: all of w)
  int sg = 0, wrow = n0;
  if constexpr (kSegs > 1) {
    sg = n0 / (N / kSegs);
    wrow = n0 - sg * (N / kSegs);
  }
  // this CTA's K slice: chunks k_lo .. k_lo + kt - 1
  const int k_lo = blockIdx.y * (ep.k_split / kBK);
  const int kt = min(K / kBK - k_lo, ep.k_split / kBK);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      hp::mbar_init(&full[s], 1);
      hp::mbar_init(&empty[s], kConsumers / 32);  // one arrival per consumer warp
    }
    hp::mbar_init_fence();
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // the producer
    if (lane == 0) {
      const CUtensorMap* wmap = &mw;
      if constexpr (kSegs > 1) {
#pragma unroll
        for (int i = 1; i < kSegs; ++i)
          if (sg == i) wmap = &segs.w[i - 1];
      }
      for (int k = 0; k < kt; ++k) {
        const int s = k % kStages;
        if (k >= kStages) hp::mbar_wait(&empty[s], ((k / kStages) - 1) & 1);
        unsigned char* st = base + s * kStageBytes;
        hp::mbar_expect_tx(&full[s], kStageBytes);
        hp::tma_load_2d(st, &ma, &full[s], (k_lo + k) * kBK, m0);
        if constexpr (kWKN) {  // the K chunk's rows of w, as two 64-column panels
          hp::tma_load_2d(st + kABytes, &mw, &full[s], n0, (k_lo + k) * kBK);
          hp::tma_load_2d(st + kABytes + kBBytes / 2, &mw, &full[s], n0 + kBN / 2,
                          (k_lo + k) * kBK);
        } else {
          hp::tma_load_2d(st + kABytes, wmap, &full[s], (k_lo + k) * kBK, wrow);
        }
      }
    }
    return;
  }

  // consumer warpgroup wg: rows 64 wg .. + 63 of the tile. One stage's
  // products stay in flight while the next stage's are issued; a stage is
  // released once its own products have completed.
  const int wg = warp >> 2;
  float acc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.0f;
  for (int k = 0; k < kt; ++k) {
    const int s = k % kStages;
    hp::mbar_wait(&full[s], (k / kStages) & 1);
    const unsigned char* a = base + s * kStageBytes + wg * 64 * 128;
    const unsigned char* w = base + s * kStageBytes + kABytes;
    hp::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      if constexpr (kWKN)  // MN-major: 16 K-rows down; panels kBBytes / 2 apart
        hp::WgmmaSS<kBN>::run<1>(acc, hp::smem_desc<128>(a + kk * 32, 16, 1024),
                                  hp::smem_desc<128>(w + kk * 16 * 128, kBBytes / 2, 1024), 1);
      else
        hp::WgmmaSS<kBN>::run<0>(acc, hp::smem_desc<128>(a + kk * 32, 16, 1024),
                                  hp::smem_desc<128>(w + kk * 32, 16, 1024), 1);
    }
    hp::wgmma_commit();
    hp::wgmma_wait<1>();
    if (k > 0 && lane == 0) hp::mbar_arrive(&empty[(k - 1) % kStages]);
  }
  hp::wgmma_wait_all();
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) hp::pin(acc[i]);

  // The epilogue: the tile into the stage memory, now free, as panels of
  // 128-byte swizzled rows (each thread's 4- or 8-byte writes conflict-
  // free), then copied out in 16-byte chunks, a row's chunks on
  // neighbouring threads. Register 4 j + e holds tile row r (+ 8 for e & 2),
  // column 8 j + 2 quad + (e & 1).
  hp::named_barrier(1, kConsumers);  // every warpgroup's products are done
  const int r = wg * 64 + (warp & 3) * 16 + (lane >> 2), quad = lane & 3;
  if constexpr (kMode == kFloat) {
    // fp32 y (+ bias): panels of 32 columns
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int c = 8 * j + 2 * quad;
      const float b0 = bias ? to_f32(bias[n0 + c]) : 0.0f;
      const float b1 = bias ? to_f32(bias[n0 + c + 1]) : 0.0f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int at = (j / 4) * kBM * 128 + hp::swizzled<128>(r + 8 * h, 2 * (j % 4) + quad / 2) +
                       8 * (quad & 1);
        *reinterpret_cast<float2*>(base + at) =
            make_float2(acc[4 * j + 2 * h] + b0, acc[4 * j + 2 * h + 1] + b1);
      }
    }
    hp::named_barrier(1, kConsumers);
    // 8 columns per thread and step: two fp32 chunks out, or (+ residual)
    // one bf16 chunk
    constexpr int kGroups = kBN / 8;
    float* part = ep.partial ? ep.partial + long(blockIdx.y) * M * N : nullptr;
    for (int i = tid; i < kBM * kGroups; i += kConsumers) {
      const int row = i / kGroups, c8 = i % kGroups;
      if (m0 + row >= M) break;  // rows grow with i
      const unsigned char* src = base + (c8 / 4) * kBM * 128;
      const float4 v0 = *reinterpret_cast<const float4*>(src + hp::swizzled<128>(row, 2 * (c8 % 4)));
      const float4 v1 =
          *reinterpret_cast<const float4*>(src + hp::swizzled<128>(row, 2 * (c8 % 4) + 1));
      const long g = long(m0 + row) * N + n0 + c8 * 8;
      if (part) {
        *reinterpret_cast<float4*>(part + g) = v0;
        *reinterpret_cast<float4*>(part + g + 4) = v1;
        continue;
      }
      float y[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
      if (ep.residual) {
        const uint4 xr = *reinterpret_cast<const uint4*>(ep.residual + g);
        const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&xr);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          y[2 * e] += __low2float(xv[e]);
          y[2 * e + 1] += __high2float(xv[e]);
        }
      }
      uint4 o;
      uint32_t* ov = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
      for (int e = 0; e < 4; ++e) ov[e] = hp::pack_bf16(y[2 * e], y[2 * e + 1]);
      *reinterpret_cast<uint4*>(ep.out[0] + g) = o;
    }
    return;
  }

  // bf16: y + bias (gelu for kGelu) rounded (and lo = y - hi), panels of 64
  // columns
  const int D = kMode == kRound ? ep.split : 0;
  const int part = D ? n0 / D : 0;  // 0 q, 1 k, 2 v (split)
  const int ld = D ? D : N, c0 = n0 - part * D;
  const bool with_lo = D && (part < 2 || ep.out[5] != nullptr);
  unsigned char* hi_tile = base;
  unsigned char* lo_tile = base + kOutBytes;
  const TV* seg_bias = nullptr;  // kSegs > 1: segment sg's, from wrow
  if constexpr (kSegs > 1) {
    seg_bias = segs.bias[0];
#pragma unroll
    for (int i = 1; i < kSegs; ++i)
      if (sg == i) seg_bias = segs.bias[i];
    seg_bias += wrow;
  }
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int c = 8 * j + 2 * quad;
    float b0, b1;
    if constexpr (kSegs > 1) {
      b0 = to_f32(seg_bias[c]);
      b1 = to_f32(seg_bias[c + 1]);
    } else {
      b0 = to_f32(bias[n0 + c]);
      b1 = to_f32(bias[n0 + c + 1]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r + 8 * h;
      float y0 = acc[4 * j + 2 * h] + b0, y1 = acc[4 * j + 2 * h + 1] + b1;
      if constexpr (kMode == kGelu) {
        y0 = gelu_erf(y0);
        y1 = gelu_erf(y1);
      }
      const int at = (j / 8) * kBM * 128 + hp::swizzled<128>(row, j % 8) + 4 * quad;
      const __nv_bfloat162 hv = __floats2bfloat162_rn(y0, y1);
      *reinterpret_cast<__nv_bfloat162*>(hi_tile + at) = hv;
      if (with_lo)
        *reinterpret_cast<__nv_bfloat162*>(lo_tile + at) =
            __floats2bfloat162_rn(y0 - __low2float(hv), y1 - __high2float(hv));
    }
  }
  hp::named_barrier(1, kConsumers);
  bf16* hi = ep.out[D ? 2 * part : 0];
  bf16* lo = with_lo ? ep.out[2 * part + 1] : nullptr;
  constexpr int kChunks = kBN / 8;  // 16-byte chunks of a tile row
  for (int i = tid; i < kBM * kChunks; i += kConsumers) {
    const int row = i / kChunks, c16 = i % kChunks;
    if (m0 + row >= M) break;  // rows grow with i
    const int at = (c16 / 8) * kBM * 128 + hp::swizzled<128>(row, c16 % 8);
    const long g = long(m0 + row) * ld + c0 + c16 * 8;
    *reinterpret_cast<uint4*>(hi + g) = *reinterpret_cast<const uint4*>(hi_tile + at);
    if (with_lo) *reinterpret_cast<uint4*>(lo + g) = *reinterpret_cast<const uint4*>(lo_tile + at);
  }
}

template <int kMode, int kSegs = 1, typename TV = float>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
gemm_wgmma(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mw,
           const __grid_constant__ Epilogue ep, int M, int N, int K,
           const __grid_constant__ Segments<kSegs, TV> segs) {
  gemm_tile<kMode, kSegs, TV, false>(ma, mw, ep, M, N, K, segs);
}

// kRound with w a (K, N) row-major matrix (B15's JAX-layout kernel)
template <typename TV>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
gemm_wgmma_kn(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mw,
              const __grid_constant__ Epilogue ep, int M, int N, int K,
              const __grid_constant__ Segments<1, TV> segs) {
  gemm_tile<kRound, 1, TV, true>(ma, mw, ep, M, N, K, segs);
}

// the 2-D map of a row-major (rows, cols) bf16 matrix, box (kBK, box_rows)
inline bool encode_matrix(CUtensorMap* map, const void* p, int rows, int cols, int box_rows) {
  const cuuint64_t dims[2] = {cuuint64_t(cols), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(cols) * 2};
  const cuuint32_t box[2] = {cuuint32_t(kBK), cuuint32_t(box_rows)}, elem[2] = {1, 1};
  return hp::encode_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(p),
                               dims, strides, box, elem,
                               CU_TENSOR_MAP_SWIZZLE_128B) == CUDA_SUCCESS;
}

// y = a (M, K) · w (N, K)ᵀ (+ bias, N values of TV) into ep under kMode; N a
// multiple of 128 (and of 3 with split = N / 3 a multiple of 128), K a
// multiple of 64, a and w 16-byte aligned. ep.k_split, a multiple of 64 (0:
// K), slices K over grid y, for kFloat into partials only. kWKN (kRound):
// y = a · w with w (K, N) row-major (gemm_wgmma_kn). Returns a cudaError_t.
template <int kMode = kRound, typename TV = float, bool kWKN = false>
int launch(const void* a, const void* w, Epilogue ep, int M, int N, int K, cudaStream_t stream) {
  if (M < 1 || N < kBN || N % kBN || K < kBK || K % kBK) return int(cudaErrorInvalidValue);
  if (ep.split && (kMode != kRound || ep.split % kBN || N != 3 * ep.split))
    return int(cudaErrorInvalidValue);
  if (kMode != kFloat && !ep.bias) return int(cudaErrorInvalidValue);
  if (!ep.k_split) ep.k_split = K;
  if (ep.k_split < 0 || ep.k_split % kBK || (ep.k_split < K && !(kMode == kFloat && ep.partial)))
    return int(cudaErrorInvalidValue);
  CUtensorMap ma, mw;
  // w (K, N): boxes of kBK rows x 64 columns (one 128-byte panel row each)
  if (!encode_matrix(&ma, a, M, K, kBM) ||
      !(kWKN ? encode_matrix(&mw, w, K, N, kBK) : encode_matrix(&mw, w, N, K, kBN)))
    return int(cudaErrorInvalidValue);
  auto kernel = [] {  // only the chosen kernel is instantiated
    if constexpr (kWKN) return gemm_wgmma_kn<TV>;
    else return gemm_wgmma<kMode, 1, TV>;
  }();
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return int(err);
  const long tiles = long(N / kBN) * ((M + kBM - 1) / kBM);
  if (tiles > 0x7fffffffL) return int(cudaErrorInvalidValue);
  const dim3 grid(unsigned(tiles), unsigned((K + ep.k_split - 1) / ep.k_split));
  kernel<<<grid, kThreads, kSmem, stream>>>(ma, mw, ep, M, N, K, Segments<1, TV>{});
  return int(cudaGetLastError());
}

// K4's packed projection: out (M, kSegs · seg) bf16 = a (M, K) · [w_0; ...;
// w_{kSegs-1}]ᵀ + [bias_0 | ... ], rounded once, each w_i (seg, K) bf16 and
// bias_i (seg) in TV read in place (no concatenation); seg a multiple of
// 128, K of 64, a and w_i 16-byte aligned. Returns a cudaError_t.
template <int kSegs, typename TV>
int launch_packed(const void* a, const void* const (&w)[kSegs], const TV* const (&bias)[kSegs],
                  bf16* out, int M, int seg, int K, cudaStream_t stream) {
  if (M < 1 || seg < kBN || seg % kBN || K < kBK || K % kBK || !out)
    return int(cudaErrorInvalidValue);
  CUtensorMap ma, mw;
  Segments<kSegs, TV> segs;
  if (!encode_matrix(&ma, a, M, K, kBM) || !encode_matrix(&mw, w[0], seg, K, kBN))
    return int(cudaErrorInvalidValue);
  for (int i = 0; i < kSegs; ++i) {
    if (!bias[i] || (i && !encode_matrix(&segs.w[i - 1], w[i], seg, K, kBN)))
      return int(cudaErrorInvalidValue);
    segs.bias[i] = bias[i];
  }
  auto kernel = gemm_wgmma<kRound, kSegs, TV>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return int(err);
  const int N = kSegs * seg;
  const long tiles = long(N / kBN) * ((M + kBM - 1) / kBM);
  if (tiles > 0x7fffffffL) return int(cudaErrorInvalidValue);
  const Epilogue ep{{out}, nullptr, 0, nullptr, nullptr, K};
  kernel<<<dim3(unsigned(tiles)), kThreads, kSmem, stream>>>(ma, mw, ep, M, N, K, segs);
  return int(cudaGetLastError());
}

}  // namespace
}  // namespace gemm
}  // namespace alpro
