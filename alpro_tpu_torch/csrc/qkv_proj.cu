// Attention plus output projection over the packed qkv, the per-head output
// rounded once and the heads summed in fp32 by the projection:
//   spatial (B7):  out = attn(qkv) . wp^T + bp,          qkv (M, S, 3D), per cell;
//   temporal (B8): out = attn_T(qkv) . w_eff^T + b_eff,  qkv (B, T, N, 3D),
//                  attention over T at each (b, n), w_eff the folded
//                  proj.temporal_fc (the residual stays outside, as in the
//                  model).
//
// Replaces the TPU kernels alpro_tpu/ops/pallas_qkv_attn.py::
// fused_attention_qkv_proj (_spatial_qkv_proj_kernel) and
// fused_temporal_attention_qkv_proj (_temporal_qkv_proj_kernel). Their
// contract is kept, their tiling (128-lane head windows, the δ-roll, N
// blocks of 8) is not:
//   * q, k and v are cast to fp32 and q is scaled by hd^-1/2 before the
//     product; scores, the exact softmax (row max first, then exp and sum)
//     and p.v are fp32;
//   * the per-head output o / l is rounded to the projection weight's dtype;
//   * the projection accumulates over all heads in fp32, then adds the fp32
//     bias and is cast to qkv's dtype.
// Weights come in torch Linear layout (out, in); biases fp32, or in bf16
// the layer's bf16 bias, widened on load.
//
// What bounds it on an H100. B7 at 8 clips x 8 frames (64 cells of 197):
// 7.6 GFLOP of attention and 14.9 GFLOP of projection against ~79 MB read
// and written: bound by bytes (0.024 ms at 3.35 TB/s). B8 at the same
// clips: 0.3 GFLOP of attention (T x T per location) and 14.8 GFLOP of
// projection against ~78 MB: bound by bytes (0.0234 ms). Neither can carry
// the projection's cross-head sum from one grid step to the next as the TPU
// grid does; the designs:
//   B7, bf16: two launches behind one C call, every product on wgmma:
//     1. attn_wgmma.cuh under kPSplit (K1's body and plan, one CTA per
//        (head, cell)): q, k and v read in place from the packed input
//        through 4-D tensor maps (bf16 values, so q·kᵀ on them is the
//        contract's fp32 product), s times hd^-1/2 (a power of two: the same
//        as scaling q first), the exact row max in registers, p = exp(s -
//        max) split into p_hi + p_lo from the fp32 score registers (p to
//        ~2^-16, where K1 rounds it), P·V = p_hi·v + p_lo·v in fp32, o / l
//        (l the fp32 sum of the unrounded p) rounded into an (M·S, D) heads
//        scratch. Past 256 keys the keys stream in chunks: S has no limit;
//     2. gemm_wgmma.cuh: heads · wpᵀ + bp over all D columns in fp32 (the
//        contract's head sum in another order), rounded once;
//   B7, fp32 (a test dtype): a heads launch, one block of 4 warps per
//     (query-tile group, head, cell) with the cell's fp32 K and V in shared
//     memory and a warp per 16 query rows running attn_f32.cuh's core,
//     writing the per-head output into an (M, S, D) scratch; then
//     row_tile.cuh's projection launch (proj_rows). S <= 256, head_dim 64;
//   B8, bf16: two launches behind one C call (B7's, with K2's attention):
//     1. K2's body (temporal_attn.cuh, its fast and wide paths): q, k, v
//        read in place, q scaled in fp32, the exact softmax over T, o / l in
//        fp32 rounded once into an (R, D) bf16 heads scratch, R = B·T·N —
//        the TPU kernel's rounding of the per-head output to w_eff's dtype;
//     2. gemm_wgmma.cuh's kRound: heads · w_effᵀ + b_eff over all D columns
//        in fp32, rounded once into the (B, T, N, D) output.
//     T <= 128, head_dim a multiple of 8 up to 128 (K2's limits), D a
//     multiple of 128 (the GEMM's column tile);
//   B8, fp32 (a test dtype): one launch per (tile of T x 32/T locations,
//     clip): the heads in groups of 4, each group's q, k, v staged in shared
//     memory, one warp per (location, head) running a warp softmax (lanes
//     over the head's channels, lane u keeping score u) and writing the
//     output into the tile's (32 x D) A tile in shared memory; then the
//     row-tile GEMM (rows::gemm) of the A tile against w_eff. T <= 32,
//     head_dim 64, D in (256, 512, 768, 1024).
#include "attn_f32.cuh"
#include "attn_wgmma.cuh"
#include "gemm_wgmma.cuh"
#include "row_tile.cuh"
#include "temporal_attn.cuh"

namespace {

using alpro::WarpTile;
using alpro::f32attn::kHD;
using alpro::f32attn::kLdF;
namespace rows = alpro::rows;

// ---- spatial (B7), fp32: the heads launch ----

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kQT = kWarps * 16;  // query rows per tile, 16 per warp

size_t spatial_smem(int SP) {
  return (2 * size_t(SP) + kQT) * kLdF * 4 +
         size_t(kWarps) * alpro::f32attn::warp_floats(SP) * 4;
}


// rows r0 .. r0 + n of the cell's head columns col .. col + 64 (row stride
// ld) into dst (fp32, leading dimension kLdF) times mul, rows S.. zero;
// thread tid of nthr, 16-byte loads
template <typename T>
__device__ __forceinline__ void stage_f32(const T* cell, long ld, int col, int r0, int n, int S,
                                          float mul, float* dst, int tid, int nthr) {
  constexpr int vx = 16 / int(sizeof(T)), vpr = kHD / vx;
  for (int i = tid; i < n * vpr; i += nthr) {
    const int r = i / vpr, c = (i % vpr) * vx;
    float* d = dst + r * kLdF + c;
    if (r0 + r < S) {
      const uint4 u = *reinterpret_cast<const uint4*>(cell + long(r0 + r) * ld + col + c);
      const T* v = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int q = 0; q < vx; ++q) d[q] = alpro::to_f32(v[q]) * mul;
    } else {
#pragma unroll
      for (int q = 0; q < vx; ++q) d[q] = 0.0f;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
spatial_proj_heads(const T* __restrict__ qkv, T* __restrict__ heads, int S, int SP, int H,
                   float scale) {
  const int h = blockIdx.y, m = blockIdx.z;
  const int D = H * kHD;
  const long ld = 3L * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + SP * kLdF;
  float* qs = Vs + SP * kLdF + warp * 16 * kLdF;  // this warp's 16 query rows
  float* wbuf = Vs + SP * kLdF + kQT * kLdF + warp * alpro::f32attn::warp_floats(SP);

  const T* cell = qkv + long(m) * S * ld;
  stage_f32<T>(cell, ld, D + h * kHD, 0, SP, S, 1.0f, Ks, threadIdx.x, kThreads);
  stage_f32<T>(cell, ld, 2 * D + h * kHD, 0, SP, S, 1.0f, Vs, threadIdx.x, kThreads);
  __syncthreads();
  // each warp walks its own 16-row query tiles: warp-level syncs only
  for (int q0 = blockIdx.x * kQT + warp * 16; q0 < S; q0 += gridDim.x * kQT) {
    stage_f32<T>(cell, ld, h * kHD, q0, 16, S, scale, qs, lane, 32);  // q * hd^-1/2
    __syncwarp();
    alpro::f32attn::attend16<T>(qs, Ks, Vs, S, SP, wbuf,
                                heads + (long(m) * S + q0) * D + h * kHD, D, S - q0);
  }
}

int spatial_f32(const float* qkv, const float* wproj, const float* bproj, float* heads,
                float* out, int M, int S, int H, int q_split, float scale, int device,
                cudaStream_t stream) {
  const int SP = (S + 15) / 16 * 16;
  const size_t smem = spatial_smem(SP);
  if (q_split < 1 || smem > size_t(alpro::max_smem_optin(device)))
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(spatial_proj_heads<float>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid(std::min(q_split, (S + kQT - 1) / kQT), H, M);
  spatial_proj_heads<float><<<grid, kThreads, smem, stream>>>(qkv, heads, S, SP, H, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  return rows::dispatch_proj<float>(H * kHD, heads, wproj, bproj, nullptr, out, M * S, stream);
}

// the bf16 route's attention plan at S keys (K1's; 0: none fits)
int spatial_plan_smem(int S, int optin) {
  return alpro::attn::plan_bf16<kHD>(S, optin, false).smem;
}

// heads: an (M·S, D) bf16 scratch; TV: the bias's dtype
template <typename TV>
int spatial_bf16(const __nv_bfloat16* qkv, const __nv_bfloat16* wproj, const TV* bproj,
                 __nv_bfloat16* heads, __nv_bfloat16* out, int M, int S, int H, float scale,
                 int device, cudaStream_t stream) {
  namespace gm = alpro::gemm;
  using alpro::attn::Operand;
  const long long D = 1LL * H * kHD, row = 3 * D * 2, cell = row * S;  // bytes: row, cell
  if (!spatial_plan_smem(S, alpro::max_smem_optin(device))) return int(cudaErrorInvalidValue);
  const Operand q{qkv, row, kHD * 2, cell}, k{qkv + D, row, kHD * 2, cell},
      v{qkv + 2 * D, row, kHD * 2, cell};
  const alpro::attn::Strides so{S * D, D, kHD};
  int err = alpro::attn::launch<kHD, false, false, false, true>(
      q, k, v, heads, so, nullptr, nullptr, nullptr, M, H, S, S, scale, 1, device, stream);
  if (err) return err;
  return gm::launch<gm::kRound, TV>(heads, wproj, gm::Epilogue{{out}, bproj, 0}, M * S, int(D),
                                    int(D), stream);
}

// ---- temporal (B8), fp32: one launch ----

constexpr int kHG = 4;  // heads per staging group

// a staged row: [q | k | v] of the group's heads, padded
template <typename T> __host__ __device__ constexpr int ld_stage() {
  return 3 * kHG * kHD + rows::vec<T>();
}

template <typename T, int NG> size_t temporal_smem() {
  constexpr int D = NG * rows::kTile;
  const size_t a = size_t(rows::kTM) * (D + rows::vec<T>()) * sizeof(T);
  const size_t staged = size_t(rows::kTM) * ld_stage<T>() * sizeof(T);
  const size_t gemm = size_t(rows::kTile) * (rows::kTile + rows::vec<T>()) * sizeof(T) +
                      size_t(rows::kWarps) * 256 * 4;
  return a + std::max(staged, gemm);
}

template <typename T, int NG>
__global__ void __launch_bounds__(rows::kThreads, 1)
temporal_proj(const T* __restrict__ qkv, const T* __restrict__ w_eff,
              const float* __restrict__ b_eff, T* __restrict__ out, int Tn, int N, int NT,
              float scale) {
  constexpr int D = NG * rows::kTile, H = D / kHD, vx = rows::vec<T>();
  constexpr int lda = D + vx, lds = ld_stage<T>(), seg = kHG * kHD, vps = seg / vx;
  static_assert(H % kHG == 0, "whole head groups");
  const int n0 = blockIdx.x * NT, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long ld = 3L * D;

  extern __shared__ __align__(128) unsigned char smem[];
  T* A = reinterpret_cast<T*>(smem);  // (kTM x D) per-head outputs, tile row t * NT + j
  T* st = A + rows::kTM * lda;        // a head group's q, k, v; later the GEMM's weight tile
  float* stage = reinterpret_cast<float*>(st + rows::kTile * (rows::kTile + vx)) + warp * 256;

  // tile row r = t * NT + j is location n0 + j of frame t of clip b
  auto row_ptr = [&](int r) -> const T* {
    const int t = r / NT, j = r % NT;
    return (t < Tn && n0 + j < N) ? qkv + ((long(b) * Tn + t) * N + n0 + j) * ld : nullptr;
  };
  for (int i = threadIdx.x; i < rows::kTM * lda / vx; i += rows::kThreads)
    reinterpret_cast<uint4*>(A)[i] = make_uint4(0, 0, 0, 0);

  const int c0 = lane * 2;  // this lane's two channels of a head
  for (int h0 = 0; h0 < H; h0 += kHG) {
    __syncthreads();  // every warp is done with the previous group
    for (int i = threadIdx.x; i < rows::kTM * 3 * vps; i += rows::kThreads) {
      const int r = i / (3 * vps), k = (i / vps) % 3, c = i % vps;
      const T* src = row_ptr(r);
      uint4 v = make_uint4(0, 0, 0, 0);
      if (src != nullptr) v = reinterpret_cast<const uint4*>(src + k * D + h0 * kHD)[c];
      reinterpret_cast<uint4*>(st + r * lds + k * seg)[c] = v;
    }
    __syncthreads();
    // one warp per (location j, head h0 + hl) of the group
    for (int task = warp; task < NT * kHG; task += rows::kWarps) {
      const int j = task / kHG, col = (task % kHG) * kHD + c0;
      if (n0 + j >= N) continue;
      for (int t = 0; t < Tn; ++t) {
        const T* qr = st + (t * NT + j) * lds + col;
        const float qa = alpro::to_f32(qr[0]) * scale, qb = alpro::to_f32(qr[1]) * scale;
        float my_s = -INFINITY;  // lane u holds score (t, u)
        for (int u = 0; u < Tn; ++u) {
          const T* kr = st + (u * NT + j) * lds + seg + col;
          const float part = alpro::warp_sum(
              fmaf(qb, alpro::to_f32(kr[1]), qa * alpro::to_f32(kr[0])));
          if (lane == u) my_s = part;
        }
        const float mx = alpro::warp_max(my_s);
        const float p = lane < Tn ? expf(my_s - mx) : 0.0f;
        const float l = alpro::warp_sum(p);
        float oa = 0.0f, ob = 0.0f;
        for (int u = 0; u < Tn; ++u) {
          const float pu = __shfl_sync(0xffffffffu, p, u);
          const T* vr = st + (u * NT + j) * lds + 2 * seg + col;
          oa = fmaf(pu, alpro::to_f32(vr[0]), oa);
          ob = fmaf(pu, alpro::to_f32(vr[1]), ob);
        }
        T* ar = A + (t * NT + j) * lda + h0 * kHD + col;
        ar[0] = alpro::from_f32<T>(oa / l);
        ar[1] = alpro::from_f32<T>(ob / l);
      }
    }
  }

  // ---- A . w_eff^T, fp32 over all heads, + b_eff into the tile's rows ----
  WarpTile<T> acc[NG];
#pragma unroll
  for (int g = 0; g < NG; ++g) acc[g].zero();
  rows::gemm<T, NG, true>(acc, A, lda, w_eff, D, NG, st);  // begins with a block sync
  const int tr = warp / (rows::kTile / 16), tc = warp % (rows::kTile / 16);
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    acc[g].store(stage, 16);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int e = lane * 8 + i, r = tr * 16 + e / 16, t = r / NT, j = r % NT;
      const int col = g * rows::kTile + tc * 16 + e % 16;
      if (t < Tn && n0 + j < N)
        out[((long(b) * Tn + t) * N + n0 + j) * D + col] =
            alpro::from_f32<T>(stage[e] + b_eff[col]);
    }
    __syncwarp();
  }
}

template <typename T, int NG>
int launch_temporal(const void* qkv, const void* w_eff, const void* b_eff, void* out, int B,
                    int Tn, int N, float scale, cudaStream_t stream) {
  const int NT = rows::kTM / Tn;  // locations per tile: T x NT <= 32 rows
  const size_t smem = temporal_smem<T, NG>();
  cudaError_t err = cudaFuncSetAttribute(temporal_proj<T, NG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid((N + NT - 1) / NT, B);
  temporal_proj<T, NG><<<grid, rows::kThreads, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const T*>(w_eff), static_cast<const float*>(b_eff),
      static_cast<T*>(out), Tn, N, NT, scale);
  return int(cudaGetLastError());
}

int temporal_f32(int D, const void* qkv, const void* w_eff, const void* b_eff, void* out, int B,
                 int Tn, int N, float scale, cudaStream_t st) {
  switch (D) {
#define ALPRO_TEMPORAL_CASE(NG) \
  case NG * rows::kTile:        \
    return launch_temporal<float, NG>(qkv, w_eff, b_eff, out, B, Tn, N, scale, st);
    ALPRO_TEMPORAL_CASE(2)
    ALPRO_TEMPORAL_CASE(4)
    ALPRO_TEMPORAL_CASE(6)
    ALPRO_TEMPORAL_CASE(8)
#undef ALPRO_TEMPORAL_CASE
    default: return int(cudaErrorInvalidValue);
  }
}

// ---- temporal (B8), bf16: K2's body into the heads, then the GEMM ----

// heads: an (R, D) bf16 scratch, R = B·T·N; TV: the bias's dtype
template <typename TV>
int temporal_bf16(const __nv_bfloat16* qkv, const __nv_bfloat16* w_eff, const TV* b_eff,
                  __nv_bfloat16* heads, __nv_bfloat16* out, int B, int Tn, int N, int H, int hd,
                  float scale, int device, cudaStream_t stream) {
  namespace gm = alpro::gemm;
  const int D = H * hd, R = B * Tn * N;
  int err = alpro::tattn::dispatch<__nv_bfloat16>(qkv, heads, B, Tn, N, H, hd, scale, device,
                                                  stream);
  if (err) return err;
  return gm::launch<gm::kRound, TV>(heads, w_eff, gm::Epilogue{{out}, b_eff, 0}, R, D, D, stream);
}

}  // namespace

// The dynamic shared memory of the spatial chain's launch at S keys on this
// device (bf16: the attention plan; fp32: the heads block), 0 where none fits.
extern "C" int alpro_spatial_qkv_proj_smem(int S, int is_bf16, int device) {
  if (S < 1) return 0;
  const int optin = alpro::max_smem_optin(device);
  if (is_bf16) return spatial_plan_smem(S, optin);
  const size_t smem = spatial_smem((S + 15) / 16 * 16);
  return smem <= size_t(optin) ? int(smem) : 0;
}

// qkv (M, S, 3D), heads (scratch) and out (M, S, D) in one dtype, wproj (D, D)
// in it, D = H * 64; bproj fp32, or bf16 (vec_bf16 1, bf16 only). fp32:
// q_split blocks per (head, cell) (at most the number of 64-row query tiles);
// bf16: q_split unused, heads (M·S, D).
extern "C" int alpro_spatial_qkv_proj(const void* qkv, const void* wproj, const void* bproj,
                                      void* heads, void* out, int M, int S, int H, int q_split,
                                      float scale, int is_bf16, int vec_bf16, int device,
                                      void* stream) {
  if (M < 1 || S < 1 || H < 1) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_bf16) {
    if (vec_bf16) return int(cudaErrorInvalidValue);
    return spatial_f32(static_cast<const float*>(qkv), static_cast<const float*>(wproj),
                       static_cast<const float*>(bproj), static_cast<float*>(heads),
                       static_cast<float*>(out), M, S, H, q_split, scale, device, st);
  }
  using bf16 = __nv_bfloat16;
  const bf16* x = static_cast<const bf16*>(qkv);
  const bf16* w = static_cast<const bf16*>(wproj);
  bf16* hs = static_cast<bf16*>(heads);
  bf16* o = static_cast<bf16*>(out);
  if (vec_bf16)
    return spatial_bf16<bf16>(x, w, static_cast<const bf16*>(bproj), hs, o, M, S, H, scale,
                              device, st);
  return spatial_bf16<float>(x, w, static_cast<const float*>(bproj), hs, o, M, S, H, scale,
                             device, st);
}

// qkv (B, T, N, 3D) and out (B, T, N, D) in one dtype, D = H * hd, w_eff
// (D, D) in it. bf16: heads an (B·T·N, D) bf16 scratch, b_eff bf16 (vec_bf16
// 1) or fp32; 1 <= T <= 128, hd a multiple of 8 up to 128, D a multiple of
// 128. fp32: heads unused, b_eff fp32; 1 <= T <= 32, hd 64, D in (256, 512,
// 768, 1024). Every limit is checked before a launch.
extern "C" int alpro_temporal_qkv_proj(const void* qkv, const void* w_eff, const void* b_eff,
                                       void* heads, void* out, int B, int Tn, int N, int H,
                                       int hd, float scale, int is_bf16, int vec_bf16,
                                       int device, void* stream) {
  if (B < 1 || N < 1 || H < 1 || Tn < 1 || long(B) * Tn * N > 0x7fffffffL)
    return int(cudaErrorInvalidValue);
  const int D = H * hd;
  if (is_bf16 ? (Tn > alpro::tattn::kMaxT || hd < 8 || hd > 128 || hd % 8 ||
                 D % alpro::gemm::kBN)
              : (vec_bf16 || hd != kHD || Tn > rows::kTM || B > 65535))
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_bf16) return temporal_f32(D, qkv, w_eff, b_eff, out, B, Tn, N, scale, st);
  using bf16 = __nv_bfloat16;
  const bf16* x = static_cast<const bf16*>(qkv);
  const bf16* w = static_cast<const bf16*>(w_eff);
  bf16* hs = static_cast<bf16*>(heads);
  bf16* o = static_cast<bf16*>(out);
  if (vec_bf16)
    return temporal_bf16<bf16>(x, w, static_cast<const bf16*>(b_eff), hs, o, B, Tn, N, H, hd,
                               scale, device, st);
  return temporal_bf16<float>(x, w, static_cast<const float*>(b_eff), hs, o, B, Tn, N, H, hd,
                              scale, device, st);
}
