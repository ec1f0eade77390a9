// Whole attention chains of the divided space-time block:
//   spatial (B9):  out = [x +] proj(softmax(q k^T) v),  x (M, S, D) per cell;
//   temporal (B10): out = x + attn_T(q, k, v) . w_eff^T + b_eff,  x (B, T, N, D),
//                   attention over T at each (b, n);
//   q, k, v = LN(x) . Wqkv^T + b per head (q scaled by hd^-1/2).
//
// Replaces the TPU kernels alpro_tpu/ops/pallas_fused_block.py::
// fused_spatial_block (_spatial_block_kernel) and fused_temporal_block
// (_temporal_block_kernel). Their rounding points are the contract kept here:
//   * one-pass fp32 LN statistics, the LN output rounded to the weights'
//     dtype, the q/k/v products accumulated in fp32 plus the bias in fp32;
//   * spatial: q, k, v stay fp32; scores, the exact softmax (row max first,
//     then exp and sum) and p.v are fp32, then o / l;
//   * temporal: q, k, v are rounded to x's dtype after their bias; the
//     attention over T runs in fp32 on them (q times hd^-1/2, the scores
//     over all T, max, exp, sum, then sum_u p_u v_u / l);
//   * the per-head output rounds to the projection weight's dtype; the
//     projection sums the heads in fp32, plus its bias (and, temporal always,
//     spatial when asked, the fp32 residual), rounded once.
// Weights come in torch Linear layout (out, in); in bf16 the LN and bias
// vectors are all the layer's bf16 (widened on load) or all fp32.
//
// What bounds it on an H100: at 8 clips x 8 frames the spatial chain is
// 67 GFLOP (44.6 of q/k/v projection, 7.6 of attention, 14.9 of output
// projection) and the temporal 59.5 GFLOP, against ~20 MB in and out each,
// so both are bound by operations (0.068 and 0.060 ms at 989 TFLOP/s). A
// Hopper block cannot carry the projection's cross-head sum from one grid
// step to the next as the TPU grid does.
//
// Spatial, bf16 (D = H * 64): four launches behind one C call, every
// product on wgmma, from the port's Hopper parts (B17's design,
// csrc/block_attn.cu, with the LN in front and p and v kept unrounded too):
//   1. ln_rows (ln_rows.cuh, K3's): xn = bf16(LN(x)) into an (M·S, D)
//      scratch;
//   2. gemm_wgmma.cuh: [q | k | v] = xn · wqkvᵀ + bqkv, written as six
//      (M·S, D) bf16 scratch tensors, q, k and v each as a pair hi =
//      bf16(y), lo = bf16(y - hi) (fp32 to ~2^-16: never rounded at the
//      contract's 2^-8);
//   3. attn_wgmma.cuh under kSplit and kPSplit, one CTA per (head, cell):
//      s = q_hi·k_hiᵀ + q_hi·k_loᵀ + q_lo·k_hiᵀ in fp32, times hd^-1/2 (a
//      power of two: the same as scaling q first), the exact row max in
//      registers, p = exp(s - max) split into p_hi + p_lo from the fp32
//      score registers, P·V = p_hi·v_hi + p_hi·v_lo + p_lo·v_hi in fp32,
//      o / l (l the fp32 sum of the unrounded p) rounded into an (M·S, D)
//      heads scratch (xn's, free by then);
//   4. gemm_wgmma.cuh: heads · wprojᵀ + bproj over all D columns in fp32
//      (the contract's head sum in another order), plus x in fp32 when
//      asked (kFloat), rounded once.
// The scratch round trip writes and reads 8 · M·S·D bf16 (~155 MB each way
// at the main shape, ~0.09 ms at 3.35 TB/s). A K slot holds k_hi, v_hi,
// v_lo and k_lo (one CTA an SM at 197 keys); past 256 keys the keys stream
// in chunks of 128 through a ring of slots, so S has no upper limit.
//
// Temporal, bf16: four launches behind one C call, R = B·T·N rows:
//   1.-2. ln_rows.cuh's launch_ln_linear (B11's whole route, csrc/
//      ln_matmul.cu): xn = bf16(LN(x)) into an (R, D) scratch, then qkv =
//      xn · wqkvᵀ + bqkv on the TMA/wgmma GEMM (kRound: fp32 sums, + bias,
//      rounded once to bf16: the contract's q, k, v) into an (R, 3D)
//      scratch, which is K2's (B, T, N, 3D) packed input as it lies;
//   3. K2's body (temporal_attn.cuh) on that scratch: q scaled in fp32, the
//      exact softmax over T, sum p v / l rounded once into the (R, D) heads
//      (xn's buffer, free by then); its TMA-staged fast path at T <= 32,
//      its wide path up to T = 128 (either: any head_dim a multiple of 8 up
//      to 128);
//   4. gemm_wgmma.cuh's kFloat: heads · w_effᵀ + b_eff + x in fp32, rounded
//      once into out (B9's step 4).
// The scratch round trip is ~4 · R·D bf16 each way (~77 MB at the main
// shape, ~0.05 ms at 3.35 TB/s). D a multiple of 128 up to 1024.
//
// Spatial and temporal fp32 (a test dtype: no tensor-core product keeps fp32
// operands; head_dim 64) keep a CUDA-core body, two launches each:
//   1. a heads launch, one block of 4 warps per (head, group of rows): the
//      rows' LN statistics first (one warp per row), then their q, k, v
//      projections with the LN applied while x is staged through shared
//      memory in 64 x 64 chunks beside the head's weight chunks (head_proj.cuh,
//      fp32 CUDA cores, one warp per 16 rows), the attention, and the
//      per-head output written into an (rows, D) scratch;
//        spatial (spatial_block_heads): per (query-tile group, head, cell),
//        fp32 K and V of the whole cell in shared memory, then per 64-row
//        query tile fp32 Q, full fp32 score rows per warp (16 x S), softmax,
//        p.V on the CUDA cores (attn_f32.cuh); S <= 256;
//        temporal (temporal_block_heads): per (patch-location tile, head,
//        clip), T x (64 / T) rows, q, k, v of the head in shared memory,
//        then a warp per (location, head): lanes over the head's channels,
//        scores by warp reductions, lane u keeping score u; T <= 32;
//   2. a projection launch (proj_rows): the row-tile GEMM of row_tile.cuh,
//      heads . W^T + bias (+ residual).
#include "attn_f32.cuh"
#include "attn_wgmma.cuh"
#include "gemm_wgmma.cuh"
#include "head_proj.cuh"
#include "ln_rows.cuh"
#include "row_tile.cuh"
#include "temporal_attn.cuh"

namespace {

using alpro::WarpTile;
using alpro::f32attn::kLdF;  // fp32 q/k/v rows (spatial)
using alpro::heads::kHD;     // head dim
using alpro::heads::kRC;     // rows per projection step
using alpro::heads::kThreads;
using alpro::heads::kWarps;
using alpro::heads::pad;
using alpro::heads::project;
using alpro::heads::staging_bytes;
using alpro::heads::store_biased;
constexpr int kQT = 64;   // spatial query rows per tile
static_assert(alpro::f32attn::kHD == kHD, "one head dim");

// ---- shared pieces of the heads launches ----

// fp32 one-pass LN statistics of rows 0..rows-1 (one warp per row, 16-byte
// loads; D % (32 * 16 / sizeof(T)) == 0); rows whose pointer is null get 0
template <typename T, typename RowFn>
__device__ __forceinline__ void ln_stats(RowFn row_ptr, int rows, int D, float eps, float* mean,
                                         float* rstd) {
  constexpr int vx = 16 / int(sizeof(T));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < rows; r += kWarps) {
    const T* src = row_ptr(r);
    float mu = 0.0f, rs = 0.0f;
    if (src != nullptr) {
      float s = 0.0f, ss = 0.0f;
#pragma unroll 4
      for (int c = lane * vx; c < D; c += 32 * vx) {
        const uint4 u = *reinterpret_cast<const uint4*>(src + c);
        const T* v = reinterpret_cast<const T*>(&u);
#pragma unroll
        for (int q = 0; q < vx; ++q) {
          const float f = alpro::to_f32(v[q]);
          s += f;
          ss = fmaf(f, f, ss);
        }
      }
      s = alpro::warp_sum(s);
      ss = alpro::warp_sum(ss);
      mu = s / D;
      rs = rsqrtf(fmaxf(ss / D - mu * mu, 0.0f) + eps);
    }
    if (lane == 0) {
      mean[r] = mu;
      rstd[r] = rs;
    }
  }
}

// ---- spatial (B9), fp32 ----

template <typename T> size_t spatial_smem(int SP) {
  return 2 * size_t(SP) * kLdF * 4 + size_t(kQT) * kLdF * 4 + 2 * size_t(SP) * 4 +
         std::max(staging_bytes<T>(2), size_t(kWarps) * alpro::f32attn::warp_floats(SP) * 4);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
spatial_block_heads(const T* __restrict__ x, const float* __restrict__ ln_s,
                    const float* __restrict__ ln_b, const T* __restrict__ wqkv,
                    const float* __restrict__ bqkv, T* __restrict__ heads, int S, int SP, int H,
                    float scale, float eps) {
  const int h = blockIdx.y, m = blockIdx.z;
  const int D = H * kHD;
  const int warp = threadIdx.x >> 5;
  const int ldsc = SP + 4;

  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + SP * kLdF;
  float* Qs = Vs + SP * kLdF;
  float* mean = Qs + kQT * kLdF;
  float* rstd = mean + SP;
  T* stage = reinterpret_cast<T*>(rstd + SP);
  float* sc = reinterpret_cast<float*>(stage) + warp * alpro::f32attn::warp_floats(SP);
  float* scr = sc + 16 * ldsc;  // 16 x 16 scratch, 32-byte aligned

  const T* xm = x + long(m) * S * D;
  auto row_ptr = [&](int r) -> const T* { return r < S ? xm + long(r) * D : nullptr; };
  ln_stats<T>(row_ptr, SP, D, eps, mean, rstd);

  // ---- fp32 K and V of head h for all SP rows ----
  const T* wkv[2] = {wqkv + long(D + h * kHD) * D, wqkv + long(2 * D + h * kHD) * D};
  WarpTile<T> kv[2][kHD / 16];
  for (int g0 = 0; g0 < SP; g0 += kRC) {
    const bool active = g0 + warp * 16 < SP;
    project<T, 2, true>(row_ptr, g0, mean, rstd, ln_s, ln_b, D, wkv, stage, kv, active);
    if (active) {
      store_biased<float>(kv[0], scr, bqkv + D + h * kHD, Ks + (g0 + warp * 16) * kLdF, kLdF,
                          1.0f);
      store_biased<float>(kv[1], scr, bqkv + 2 * D + h * kHD, Vs + (g0 + warp * 16) * kLdF,
                          kLdF, 1.0f);
    }
  }

  const T* wq[1] = {wqkv + long(h) * kHD * D};
  for (int q0 = blockIdx.x * kQT; q0 < S; q0 += gridDim.x * kQT) {
    const bool active = q0 + warp * 16 < S;
    WarpTile<T> qa[1][kHD / 16];
    project<T, 1, true>(row_ptr, q0, mean, rstd, ln_s, ln_b, D, wq, stage, qa, active);
    if (!active) continue;  // no block sync follows before the next project
    float* qs = Qs + warp * 16 * kLdF;
    store_biased<float>(qa[0], scr, bqkv + h * kHD, qs, kLdF, scale);  // q * hd^-1/2
    alpro::f32attn::attend16<T>(qs, Ks, Vs, S, SP, sc,
                                heads + (long(m) * S + q0 + warp * 16) * D + h * kHD, D,
                                S - q0 - warp * 16);
  }
}

// ---- temporal (B10) ----

template <typename T> __host__ __device__ constexpr int ldq() { return kHD + pad<T>(); }
template <typename T> size_t temporal_smem() {
  return 2 * size_t(kRC) * 4 + 3 * size_t(kRC) * ldq<T>() * sizeof(T) +
         std::max(staging_bytes<T>(3), size_t(kWarps) * 256 * 4);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
temporal_block_heads(const T* __restrict__ x, const float* __restrict__ ln_s,
                     const float* __restrict__ ln_b, const T* __restrict__ wqkv,
                     const float* __restrict__ bqkv, T* __restrict__ heads, int Tn, int N,
                     int NT, int H, float scale, float eps) {
  const int n0 = blockIdx.x * NT, h = blockIdx.y, b = blockIdx.z;
  const int D = H * kHD;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  constexpr int lq = ldq<T>();

  extern __shared__ __align__(128) unsigned char smem[];
  T* Qs = reinterpret_cast<T*>(smem);
  T* Ks = Qs + kRC * lq;
  T* Vs = Ks + kRC * lq;
  float* mean = reinterpret_cast<float*>(Vs + kRC * lq);
  float* rstd = mean + kRC;
  T* stage = reinterpret_cast<T*>(rstd + kRC);
  float* scr = reinterpret_cast<float*>(stage) + warp * 256;

  // local row r = t * NT + j is x[b, t, n0 + j]
  auto row_ptr = [&](int r) -> const T* {
    const int t = r / NT, j = r % NT;
    return (t < Tn && n0 + j < N) ? x + ((long(b) * Tn + t) * N + n0 + j) * D : nullptr;
  };
  ln_stats<T>(row_ptr, kRC, D, eps, mean, rstd);

  const T* w[3] = {wqkv + long(h) * kHD * D, wqkv + long(D + h * kHD) * D,
                   wqkv + long(2 * D + h * kHD) * D};
  WarpTile<T> acc[3][kHD / 16];
  const bool active = warp * 16 < Tn * NT;
  project<T, 3, true>(row_ptr, 0, mean, rstd, ln_s, ln_b, D, w, stage, acc, active);
  if (active) {
    const int r0 = warp * 16;
    store_biased<T>(acc[0], scr, bqkv + h * kHD, Qs + r0 * lq, lq, 1.0f);
    store_biased<T>(acc[1], scr, bqkv + D + h * kHD, Ks + r0 * lq, lq, 1.0f);
    store_biased<T>(acc[2], scr, bqkv + 2 * D + h * kHD, Vs + r0 * lq, lq, 1.0f);
  }
  __syncthreads();

  // ---- attention over T at each location, one warp per location: lane
  //      channels 2l, 2l+1; lane u keeps score u ----
  const int c0 = lane * 2;
  for (int j = warp; j < NT && n0 + j < N; j += kWarps) {
    for (int t = 0; t < Tn; ++t) {
      const T* qr = Qs + (t * NT + j) * lq;
      const float qa = alpro::to_f32(qr[c0]) * scale, qb = alpro::to_f32(qr[c0 + 1]) * scale;
      float my_s = -INFINITY;
      for (int u = 0; u < Tn; ++u) {
        const T* kr = Ks + (u * NT + j) * lq;
        const float part = alpro::warp_sum(
            fmaf(qb, alpro::to_f32(kr[c0 + 1]), qa * alpro::to_f32(kr[c0])));
        if (lane == u) my_s = part;
      }
      const float mx = alpro::warp_max(my_s);
      const float p = lane < Tn ? expf(my_s - mx) : 0.0f;
      const float l = alpro::warp_sum(p);
      float oa = 0.0f, ob = 0.0f;
      for (int u = 0; u < Tn; ++u) {
        const float pu = __shfl_sync(0xffffffffu, p, u);
        const T* vr = Vs + (u * NT + j) * lq;
        oa = fmaf(pu, alpro::to_f32(vr[c0]), oa);
        ob = fmaf(pu, alpro::to_f32(vr[c0 + 1]), ob);
      }
      T* orow = heads + ((long(b) * Tn + t) * N + n0 + j) * D + h * kHD;
      orow[c0] = alpro::from_f32<T>(oa / l);
      orow[c0 + 1] = alpro::from_f32<T>(ob / l);
    }
  }
}

int spatial_f32(const float* x, const float* ln_s, const float* ln_b, const float* wqkv,
                const float* bqkv, const float* wproj, const float* bproj, float* heads,
                float* out, int M, int S, int H, int q_split, float scale, float eps,
                int residual, int device, cudaStream_t stream) {
  const int SP = (S + 15) / 16 * 16;
  const size_t smem = spatial_smem<float>(SP);
  if (q_split < 1 || smem > size_t(alpro::max_smem_optin(device)))
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(spatial_block_heads<float>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid(std::min(q_split, (S + kQT - 1) / kQT), H, M);
  spatial_block_heads<float><<<grid, kThreads, smem, stream>>>(x, ln_s, ln_b, wqkv, bqkv, heads,
                                                               S, SP, H, scale, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  return alpro::rows::dispatch_proj<float>(H * kHD, heads, wproj, bproj, residual ? x : nullptr,
                                           out, M * S, stream);
}

// the bf16 route's attention plan at S keys (kSplit with v_lo; 0: none fits)
int spatial_plan_smem(int S, int optin) {
  return alpro::attn::plan_bf16<kHD>(S, optin, false, true, true).smem;
}

// scratch: seven (M·S, D) bf16 tensors, xn (then the heads), q_hi, q_lo,
// k_hi, k_lo, v_hi, v_lo; TV: the LN and bias vectors' dtype
template <typename TV>
int spatial_bf16(const __nv_bfloat16* x, const TV* ln_s, const TV* ln_b,
                 const __nv_bfloat16* wqkv, const TV* bqkv, const __nv_bfloat16* wproj,
                 const TV* bproj, __nv_bfloat16* scratch, __nv_bfloat16* out, int M, int S, int H,
                 float scale, float eps, int residual, int device, cudaStream_t stream) {
  namespace gm = alpro::gemm;
  using alpro::attn::Operand;
  const int D = H * kHD, R = M * S;
  if (!spatial_plan_smem(S, alpro::max_smem_optin(device))) return int(cudaErrorInvalidValue);
  __nv_bfloat16* part[7];
  for (int i = 0; i < 7; ++i) part[i] = scratch + long(i) * R * D;
  int err = alpro::launch_ln_rows<TV>(x, ln_s, ln_b, part[0], R, D, eps, stream);
  if (err) return err;
  const gm::Epilogue qkv{{part[1], part[2], part[3], part[4], part[5], part[6]}, bqkv, D};
  err = gm::launch<gm::kRound, TV>(part[0], wqkv, qkv, R, 3 * D, D, stream);
  if (err) return err;
  // each operand (M, S, H, 64): byte strides of the sequence, head and cell
  auto operand = [&](int i) { return Operand{part[i], 2LL * D, 2LL * kHD, 2LL * S * D}; };
  const Operand lo[3] = {operand(2), operand(4), operand(6)};
  const alpro::attn::Strides so{static_cast<long long>(S) * D, D, kHD};
  err = alpro::attn::launch<kHD, false, false, true, true>(
      operand(1), operand(3), operand(5), part[0], so, nullptr, nullptr, nullptr, M, H, S, S,
      scale, 1, device, stream, lo);
  if (err) return err;
  if (residual)
    return gm::launch<gm::kFloat, TV>(part[0], wproj,
                                      gm::Epilogue{{out}, bproj, 0, nullptr, x, 0}, R, D, D,
                                      stream);
  return gm::launch<gm::kRound, TV>(part[0], wproj, gm::Epilogue{{out}, bproj, 0}, R, D, D,
                                    stream);
}

int temporal_f32(const float* x, const float* ln_s, const float* ln_b, const float* wqkv,
                 const float* bqkv, const float* w_eff, const float* b_eff, float* heads,
                 float* out, int B, int Tn, int N, int H, float scale, float eps,
                 cudaStream_t stream) {
  const int NT = kRC / Tn;  // patch locations per block: T x NT <= 64 rows
  const size_t smem = temporal_smem<float>();
  cudaError_t err = cudaFuncSetAttribute(temporal_block_heads<float>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid((N + NT - 1) / NT, H, B);
  temporal_block_heads<float><<<grid, kThreads, smem, stream>>>(x, ln_s, ln_b, wqkv, bqkv, heads,
                                                                Tn, N, NT, H, scale, eps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  return alpro::rows::dispatch_proj<float>(H * kHD, heads, w_eff, b_eff, x, out, B * Tn * N,
                                           stream);
}

// scratch: (R, 4D) bf16, R = B·T·N: xn (R, D), then the heads in its place,
// and the packed qkv (R, 3D), which is K2's (B, T, N, 3D) input as it is;
// TV: the LN and bias vectors' dtype
template <typename TV>
int temporal_bf16(const __nv_bfloat16* x, const TV* ln_s, const TV* ln_b,
                  const __nv_bfloat16* wqkv, const TV* bqkv, const __nv_bfloat16* w_eff,
                  const TV* b_eff, __nv_bfloat16* scratch, __nv_bfloat16* out, int B, int Tn,
                  int N, int H, int hd, float scale, float eps, int device, cudaStream_t stream) {
  namespace gm = alpro::gemm;
  const int D = H * hd, R = B * Tn * N;
  __nv_bfloat16* xn = scratch;
  __nv_bfloat16* qkv = scratch + long(R) * D;
  int err = alpro::launch_ln_linear<TV>(x, ln_s, ln_b, wqkv, bqkv, xn, qkv, R, D, 3 * D, eps,
                                        stream);
  if (err) return err;
  err = alpro::tattn::dispatch<__nv_bfloat16>(qkv, xn, B, Tn, N, H, hd, scale, device, stream);
  if (err) return err;
  return gm::launch<gm::kFloat, TV>(xn, w_eff, gm::Epilogue{{out}, b_eff, 0, nullptr, x, 0}, R, D,
                                    D, stream);
}

}  // namespace

// The dynamic shared memory of the spatial chain's launch at S keys on this
// device (bf16: the attention plan; fp32: the heads block), 0 where none fits.
extern "C" int alpro_fused_spatial_smem(int S, int is_bf16, int device) {
  if (S < 1) return 0;
  const int optin = alpro::max_smem_optin(device);
  if (is_bf16) return spatial_plan_smem(S, optin);
  const size_t smem = spatial_smem<float>((S + 15) / 16 * 16);
  return smem <= size_t(optin) ? int(smem) : 0;
}

// x, out: (M, S, H * 64) in one dtype; wqkv (3D, D) and wproj (D, D) in it.
// bf16: ln_*, bqkv, bproj all bf16 (vec_bf16 1) or all fp32; scratch seven
// (M·S, D) bf16 tensors; q_split unused. fp32: the vectors fp32, scratch one
// (M, S, D) tensor of heads, q_split blocks per (head, cell) (at most the
// number of 64-row query tiles).
extern "C" int alpro_fused_spatial_block(const void* x, const void* ln_s, const void* ln_b,
                                         const void* wqkv, const void* bqkv, const void* wproj,
                                         const void* bproj, void* scratch, void* out, int M,
                                         int S, int H, int q_split, float scale, float eps,
                                         int residual, int is_bf16, int vec_bf16, int device,
                                         void* stream) {
  if (M < 1 || S < 1 || H < 1) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_bf16) {
    if (vec_bf16) return int(cudaErrorInvalidValue);
    auto f = [](const void* p) { return static_cast<const float*>(p); };
    return spatial_f32(f(x), f(ln_s), f(ln_b), f(wqkv), f(bqkv), f(wproj), f(bproj),
                       static_cast<float*>(scratch), static_cast<float*>(out), M, S, H, q_split,
                       scale, eps, residual, device, st);
  }
  using bf16 = __nv_bfloat16;
  auto w = [](const void* p) { return static_cast<const bf16*>(p); };
  bf16* sc = static_cast<bf16*>(scratch);
  bf16* o = static_cast<bf16*>(out);
  if (vec_bf16)
    return spatial_bf16<bf16>(w(x), w(ln_s), w(ln_b), w(wqkv), w(bqkv), w(wproj), w(bproj), sc,
                              o, M, S, H, scale, eps, residual, device, st);
  auto v = [](const void* p) { return static_cast<const float*>(p); };
  return spatial_bf16<float>(w(x), v(ln_s), v(ln_b), w(wqkv), v(bqkv), w(wproj), v(bproj), sc, o,
                             M, S, H, scale, eps, residual, device, st);
}

// x, out: (B, T, N, H * hd) in one dtype, wqkv (3D, D) and w_eff (D, D) in
// it. bf16: ln_*, bqkv, b_eff all bf16 (vec_bf16 1) or all fp32; scratch
// (B·T·N, 4D) bf16; 1 <= T <= 128, hd a multiple of 8 up to 128, D = H·hd a
// multiple of 128 up to 1024. fp32: the vectors fp32, scratch the (B, T, N,
// D) heads; hd 64, 1 <= T <= 32. Every limit is checked before a launch.
extern "C" int alpro_fused_temporal_block(const void* x, const void* ln_s, const void* ln_b,
                                          const void* wqkv, const void* bqkv, const void* w_eff,
                                          const void* b_eff, void* scratch, void* out, int B,
                                          int Tn, int N, int H, int hd, float scale, float eps,
                                          int is_bf16, int vec_bf16, int device, void* stream) {
  if (B < 1 || N < 1 || H < 1 || Tn < 1 || long(B) * Tn * N > 0x7fffffffL)
    return int(cudaErrorInvalidValue);
  const int D = H * hd;
  if (is_bf16 ? (Tn > alpro::tattn::kMaxT || hd < 8 || hd > 128 || hd % 8 ||
                 D % alpro::gemm::kBN || D > 1024)
              : (vec_bf16 || hd != kHD || Tn > 32))
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_bf16) {
    auto f = [](const void* p) { return static_cast<const float*>(p); };
    return temporal_f32(f(x), f(ln_s), f(ln_b), f(wqkv), f(bqkv), f(w_eff), f(b_eff),
                        static_cast<float*>(scratch), static_cast<float*>(out), B, Tn, N, H,
                        scale, eps, st);
  }
  using bf16 = __nv_bfloat16;
  auto w = [](const void* p) { return static_cast<const bf16*>(p); };
  bf16* sc = static_cast<bf16*>(scratch);
  bf16* o = static_cast<bf16*>(out);
  if (vec_bf16)
    return temporal_bf16<bf16>(w(x), w(ln_s), w(ln_b), w(wqkv), w(bqkv), w(w_eff), w(b_eff), sc,
                               o, B, Tn, N, H, hd, scale, eps, device, st);
  auto v = [](const void* p) { return static_cast<const float*>(p); };
  return temporal_bf16<float>(w(x), v(ln_s), v(ln_b), w(wqkv), v(bqkv), w(w_eff), v(b_eff), sc,
                              o, B, Tn, N, H, hd, scale, eps, device, st);
}
