// Spatial (per-frame) attention over packed qkv: (M, S, 3D) -> (M, S, D).
//
// Replaces the TPU kernel alpro_tpu/ops/pallas_qkv_attn.py::fused_attention_qkv
// (_spatial_kernel). Contract kept from it, tiling not:
//   * q, k and v are read in place from the packed [q | k | v] channels (each
//     head-major), by offsets: no head-split copies and no padding of S in
//     device memory (the ragged S = 197 edge is zero-filled in shared memory);
//   * scores are QK^T on the stored operands with fp32 accumulation, the scale
//     is applied to the fp32 scores, then an fp32 max and exp; the row sum l
//     is taken from the fp32 p; p is cast to the input dtype for PV (fp32
//     accumulation) and o / l is written in the input dtype.
//
// What bounds it on an H100: per (frame, head) the work is two 197x197x64
// products, 5 MFLOP over 75 KB of q/k/v, so it is compute- and latency-bound,
// not bound by device memory. Design: one block per (query tile, head,
// frame); the head's K and V (S x hd) sit in shared memory, each warp owns 16
// query rows and keeps its full 16 x S fp32 score rows in shared memory, so
// the softmax is exact two-pass (max, then exp and sum) like the TPU kernel.
// The query tile is as large as shared memory allows — 128 rows (8 warps) in
// bf16, 64 (4 warps) in fp32 — so K and V are staged for as many queries as
// possible and the SM holds as many warps as possible; warps whose rows all
// lie past S stop after the staging. bf16 products run on the tensor cores
// (WMMA 16x16x16); fp32 inputs take the same code on the CUDA cores
// (warp_tile.cuh).
//
// The CLS-sideband variant (kCls) replaces the TPU kernel
// pallas_qkv_attn.py::fused_attention_qkv_cls (_spatial_cls_kernel): the
// frame's sequence is [CLS | N patches], where the CLS row is one per-sample
// row of qkv_c (frame m reads row m / T), so the (B, T, 1 + N, 3D) concat is
// never materialized. Row 0 of Q, K and V is staged from qkv_c, rows 1..N
// from the frame's N patch rows; query row 0's output goes to out_c, the
// others to out. Its one numerical difference from K1 is the TPU kernel's
// contract: the CLS key column's probability stays fp32 in the p.V sum (its
// p is zeroed in the rounded p tile and added as p_cls * v_cls in fp32 at
// the end), while the patch columns' p is rounded to the input dtype as in
// K1. The bound is K1's: the same block per (query tile, head, frame).
#include "warp_tile.cuh"

namespace {

// query rows per block, one warp per 16 rows
template <typename T> __host__ __device__ constexpr int query_tile() {
  return sizeof(T) == 2 ? 128 : 64;
}
template <typename T> __host__ __device__ constexpr int threads() {
  return query_tile<T>() / 16 * 32;
}

template <typename T>
size_t smem_bytes(int SP, int hd) {
  constexpr size_t kQT = query_tile<T>(), elt = sizeof(T);
  return 2 * size_t(SP) * hd * elt      // K, V
         + kQT * hd * elt               // Q tile
         + kQT * SP * 4                 // fp32 scores, then p in place
         + kQT * hd * 4                 // fp32 o
         + 2 * kQT * 4;                 // row sums l, CLS-column p (kCls)
}

// S: the sequence length per frame (1 + N when kCls). kCls: qkv and out hold
// the N = S - 1 patch rows per frame, qkv_c and out_c the CLS rows (qkv_c
// one per sample of Tn frames, out_c one per frame).
template <typename T, bool kCls>
__global__ void __launch_bounds__(threads<T>())
spatial_attn_kernel(const T* __restrict__ qkv, T* __restrict__ out, const T* __restrict__ qkv_c,
                    T* __restrict__ out_c, int S, int SP, int H, int hd, float scale, int Tn) {
  constexpr int kQT = query_tile<T>(), kThreads = threads<T>();
  const int q0 = blockIdx.x * kQT, h = blockIdx.y, m = blockIdx.z;
  const int D = H * hd;
  const long ld = 3L * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  extern __shared__ __align__(128) unsigned char smem[];
  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = Ks + SP * hd;
  T* Qs = Vs + SP * hd;
  float* Sc = reinterpret_cast<float*>(Qs + kQT * hd);
  float* Os = Sc + kQT * SP;
  float* lsum = Os + kQT * hd;
  float* pcls = lsum + kQT;  // kCls: the fp32 p of the CLS key column per query row
  // p overwrites the scores in place: row r of p (type T) starts where row r
  // of the fp32 scores starts, so its leading dimension is SP*4/sizeof(T)
  T* Ps = reinterpret_cast<T*>(Sc);
  const int ldp = SP * int(sizeof(float) / sizeof(T));

  // packed qkv row s of frame m, and its output row
  auto in_row = [&](int s) -> const T* {
    if constexpr (kCls)
      return s == 0 ? qkv_c + long(m / Tn) * ld : qkv + (long(m) * (S - 1) + s - 1) * ld;
    return qkv + (long(m) * S + s) * ld;
  };
  auto out_row = [&](int s) -> T* {
    if constexpr (kCls)
      return s == 0 ? out_c + long(m) * D : out + (long(m) * (S - 1) + s - 1) * D;
    return out + (long(m) * S + s) * D;
  };

  // ---- stage K, V (all SP rows) and this block's Q rows; zero past S ----
  const int cpr = hd * int(sizeof(T)) / 16;  // 16-byte chunks per head row
  for (int i = threadIdx.x; i < SP * cpr; i += kThreads) {
    const int r = i / cpr, c = i % cpr;
    uint4 kv = make_uint4(0, 0, 0, 0), vv = kv;
    if (r < S) {
      const T* row = in_row(r);
      kv = reinterpret_cast<const uint4*>(row + D + h * hd)[c];
      vv = reinterpret_cast<const uint4*>(row + 2 * D + h * hd)[c];
    }
    reinterpret_cast<uint4*>(Ks + r * hd)[c] = kv;
    reinterpret_cast<uint4*>(Vs + r * hd)[c] = vv;
  }
  for (int i = threadIdx.x; i < kQT * cpr; i += kThreads) {
    const int r = i / cpr, c = i % cpr, s = q0 + r;
    uint4 qv = make_uint4(0, 0, 0, 0);
    if (s < S) qv = reinterpret_cast<const uint4*>(in_row(s) + h * hd)[c];
    reinterpret_cast<uint4*>(Qs + r * hd)[c] = qv;
  }
  __syncthreads();

  const int r0 = warp * 16;
  if (q0 + r0 >= S) return;  // no valid query row in this warp (no block syncs follow)
  // ---- scores: (16 x hd) . (hd x SP), fp32 accumulation ----
  for (int j = 0; j < SP / 16; ++j) {
    alpro::WarpTile<T> acc;
    acc.zero();
    for (int kk = 0; kk < hd / 16; ++kk)
      acc.template mma<true>(Qs + r0 * hd + kk * 16, hd, Ks + j * 16 * hd + kk * 16, hd);
    acc.store(Sc + r0 * SP + j * 16, SP);
  }
  __syncwarp();

  // ---- softmax per row: fp32 max, exp, sum; p cast to T in place ----
  for (int r = r0; r < r0 + 16; ++r) {
    const float* srow = Sc + r * SP;
    float mx = -INFINITY;
    for (int c = lane; c < S; c += 32) mx = fmaxf(mx, srow[c] * scale);
    mx = alpro::warp_max(mx);
    float l = 0.0f;
    T* prow = Ps + r * ldp;
    // ascending columns: writing p[c] (sizeof(T) bytes) only clobbers score
    // bytes at or before column c, which every lane read before the
    // __syncwarp of this or an earlier step
    for (int c0 = 0; c0 < SP; c0 += 32) {
      const int c = c0 + lane;
      float p = 0.0f;
      if (c < S) {
        p = expf(srow[c] * scale - mx);
        l += p;
      }
      __syncwarp();
      if (c < SP) prow[c] = alpro::from_f32<T>(kCls && c == 0 ? 0.0f : p);
      if (kCls && c == 0) pcls[r] = p;
      __syncwarp();
    }
    l = alpro::warp_sum(l);
    if (lane == 0) lsum[r] = l;
  }
  __syncwarp();

  // ---- o = p . V: (16 x SP) . (SP x hd), fp32 accumulation ----
  for (int jj = 0; jj < hd / 16; ++jj) {
    alpro::WarpTile<T> acc;
    acc.zero();
    for (int j = 0; j < SP / 16; ++j)
      acc.template mma<false>(Ps + r0 * ldp + j * 16, ldp, Vs + j * 16 * hd + jj * 16, hd);
    acc.store(Os + r0 * hd + jj * 16, hd);
  }
  __syncwarp();

  // ---- o / l in the input dtype ----
  for (int r = r0; r < r0 + 16; ++r) {
    const int s = q0 + r;
    if (s >= S) break;
    const float inv_l = 1.0f / lsum[r];
    T* orow = out_row(s) + h * hd;
    for (int c = lane; c < hd; c += 32) {
      float o = Os[r * hd + c];
      if (kCls) o += pcls[r] * alpro::to_f32(Vs[c]);  // V row 0 is the CLS value
      orow[c] = alpro::from_f32<T>(o * inv_l);
    }
  }
}

template <typename T, bool kCls>
int launch(const void* qkv, void* out, const void* qkv_c, void* out_c, int M, int S, int H,
           int hd, float scale, int Tn, cudaStream_t stream) {
  const int SP = (S + 15) / 16 * 16;
  const size_t smem = smem_bytes<T>(SP, hd);
  cudaError_t err = cudaFuncSetAttribute(spatial_attn_kernel<T, kCls>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid((S + query_tile<T>() - 1) / query_tile<T>(), H, M);
  spatial_attn_kernel<T, kCls><<<grid, threads<T>(), smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), static_cast<const T*>(qkv_c),
      static_cast<T*>(out_c), S, SP, H, hd, scale, Tn);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" int alpro_spatial_attn(const void* qkv, void* out, int M, int S, int H, int hd,
                                  float scale, int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16
             ? launch<__nv_bfloat16, false>(qkv, out, nullptr, nullptr, M, S, H, hd, scale, 1, s)
             : launch<float, false>(qkv, out, nullptr, nullptr, M, S, H, hd, scale, 1, s);
}

// qkv_x (M, N, 3D) patch rows and qkv_c (M / T, 1, 3D) CLS rows -> out_x
// (M, N, D) and out_c (M, 1, D); M % T == 0.
extern "C" int alpro_spatial_cls_attn(const void* qkv_x, const void* qkv_c, void* out_x,
                                      void* out_c, int M, int N, int T, int H, int hd,
                                      float scale, int is_bf16, int device, void* stream) {
  if (M < 1 || N < 1 || T < 1 || M % T) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16, true>(qkv_x, out_x, qkv_c, out_c, M, N + 1, H, hd, scale,
                                               T, s)
                 : launch<float, true>(qkv_x, out_x, qkv_c, out_c, M, N + 1, H, hd, scale, T, s);
}
