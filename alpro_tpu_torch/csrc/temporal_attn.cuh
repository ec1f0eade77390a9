// K2's body: attention over T on packed qkv in the model's native layout,
// (B, T, N, 3D) -> (B, T, N, D), at each (b, n) and head. Shared by K2 and
// B16 (csrc/temporal_attn.cu), B10's bf16 route (csrc/fused_block.cu), which
// runs it on the (R, 3D) qkv scratch of its LN -> qkv GEMM, and B8's bf16
// route (csrc/qkv_proj.cu), which runs it into the heads scratch of its
// projection GEMM; each .cu owns its instantiations (an unnamed namespace).
//
// Replaces the TPU kernel alpro_tpu/ops/pallas_qkv_attn.py::
// fused_temporal_attention_qkv (_temporal_kernel; its off-by-flag lowerings
// _temporal_kernel_flash and _temporal_kernel_seg compute the same). Contract
// kept from it: q, k, v read in place from the (B, T, N, 3D) tensor and the
// output written as (B, T, N, D), with no relayout to (B*N, T, D); all math
// in fp32 with q pre-scaled; each score a dot product over head_dim; softmax
// as the row max, then exp, then the sum l, then sum_u p_u v_u / l, rounded
// once. The delta-roll formulation and the N blocking are Mosaic/VMEM
// artefacts and are not carried over.
//
// What bounds it on an H100: per (b, n, head) it is a T x T score block over
// hd — about 4*T*T*hd FLOP against 3*T*hd elements read — so it moves bytes,
// not FLOPs: at the flagship shape (8, 8, 196, 2304) bf16 it reads the qkv
// tensor once (58 MB) and writes the output once (19 MB), 77 MB, 0.0230 ms
// at 3.35 TB/s.
//
// The design keeps the bytes the only cost: no per-element load
// instruction, no widening copy and no warp butterfly per score. The fast
// path (temporal_attn_tma; T <= 32, any head_dim that is a multiple of 8 up
// to 128): a tile is the T frames of NT locations and G heads of one clip.
// Persistent CTAs walk the tiles with a ring of two stages: one thread
// issues three TMA loads per tile (q, k and v: boxes {G*hd, 1, 1, NT, T} of a
// 5-D map {G*hd, H/G, 3, N, B*T} over the packed input, a head group's
// channels one contiguous box row, the ragged edge of N zero-filled) on the
// stage's mbarrier, two tiles ahead, so the next tile's bytes arrive while
// this one is computed. One thread owns one (t, location, head) query row:
// it reads its q and the T k rows of its (location, head) from shared memory
// in 16-byte chunks (8 bf16), widens them in registers and keeps the T fp32
// scores, the max and l in registers — no cross-lane step at all — then sums
// p_u v_u chunk by chunk and writes o / l over its own q row, which a TMA
// store (a box of a 4-D map {G*hd, H/G, N, B*T} over the output, the ragged
// edge clipped) sends out as one coalesced box. The loops over the T frames
// do not branch (frames past T in the last TMAX bucket read a real row and
// are masked), so a chunk's T loads issue together. The threads of a
// (location, head) are consecutive and take their chunks in an order rotated
// by t, so the 8 threads of a quarter-warp read 8 different 16-byte columns:
// distinct banks for a 128-byte head row. The dot products are summed in
// that rotated order (fp32, as the contract asks; only the order of the
// terms differs from a lane-parallel sum), and o / l is the correctly
// rounded quotient (Markstein: q0 = o * RN(1/l), then one fma correction),
// as a division gives.
//
// The same function also replaces alpro_tpu/ops/pallas_temporal_attn.py::
// temporal_attention_roll (B16): its kernel scales q in fp32, takes the fp32
// bands q.k over every key, then max, exp, sum and sum_u p_u v_u / l, rounded
// once, which is the contract above (the delta order of its sums is Mosaic
// tiling). What B16 adds is the envelope: any head_dim and any T. Past T =
// 32, or where the fast path's two stages do not fit shared memory,
// temporal_attn_wide takes every head_dim that is a multiple of 8 up to 128
// (one warp per (b, n, head): lane l holds channels l, l + 32, .. of its
// fp32 K and V in shared memory, lanes past head_dim idle) and T <= kMaxT
// (lane l holds scores u = l, l + 32, .., each a warp-reduced dot product),
// with as many warps per block as the warps' fp32 K and V (2 * T * head_dim
// floats each) fit in shared memory.
#pragma once

#include <algorithm>

#include "hopper.cuh"
#include "warp_tile.cuh"

namespace alpro {
namespace tattn {
namespace {

namespace hp = alpro::hopper;

constexpr int kWarps = 4;  // temporal_attn_wide: warps per block, at most
constexpr int kThreads = kWarps * 32;
constexpr int kMaxT = 128;  // temporal_attn_wide: up to 4 scores per lane

// ---- the fast path ----

constexpr int kFastMaxT = 32;
constexpr int kRowThreads = 128;   // query rows (threads) of a tile, at most
constexpr int kStageBytes = 49152;  // q, k and v of a tile, at most (one row: 1 tile)
constexpr int kStages = 2;  // tiles in flight: the one computed and the next
constexpr int kBarBytes = 128;  // the stages' mbarriers, before the stages

// (location, head) rows of a tile at T frames, head_dim hd, elem-byte values
inline int fast_rows(int Tn, int hd, int elem) {
  return std::max(1, std::min(kRowThreads / Tn, kStageBytes / (3 * Tn * hd * elem)));
}
// bytes of one of a stage's q, k and v boxes, rounded up to 128
inline size_t fast_region(int Tn, int hd, int elem) {
  return (size_t(Tn) * fast_rows(Tn, hd, elem) * hd * elem + 127) / 128 * 128;
}
// the fast path's dynamic shared memory
inline size_t fast_smem(int Tn, int hd, int elem) {
  return kBarBytes + size_t(kStages) * 3 * fast_region(Tn, hd, elem);
}

// 16 bytes of T as fp32: 8 bf16 (the low half of a word first) or 4 floats
template <typename T> __device__ __forceinline__ void widen(const uint4& u, float* f);
template <> __device__ __forceinline__ void widen<__nv_bfloat16>(const uint4& u, float* f) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
template <> __device__ __forceinline__ void widen<float>(const uint4& u, float* f) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

// fp32 values rounded to 16 bytes of T
template <typename T> __device__ __forceinline__ uint4 narrow(const float* f);
template <> __device__ __forceinline__ uint4 narrow<__nv_bfloat16>(const float* f) {
  return make_uint4(hp::pack_bf16(f[0], f[1]), hp::pack_bf16(f[2], f[3]),
                    hp::pack_bf16(f[4], f[5]), hp::pack_bf16(f[6], f[7]));
}
template <> __device__ __forceinline__ uint4 narrow<float>(const float* f) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}

// Tile (b, nt, ht): locations nt*NT.. and heads ht*G.. of clip b, ht fastest;
// a block's threads are (t, g, n) with t fastest; TMAX >= Tn.
template <typename T, int TMAX>
__global__ void __launch_bounds__(kRowThreads, 1)
temporal_attn_tma(const __grid_constant__ CUtensorMap in_map,
                  const __grid_constant__ CUtensorMap out_map, int Tn, int hd, int NT, int G,
                  int n_tiles, int h_tiles, long tiles, int region, float scale) {
  constexpr int V = 16 / int(sizeof(T));  // values per 16-byte chunk
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  auto stage = [&](int s) { return smem + kBarBytes + size_t(s) * 3 * region; };

  const int tid = threadIdx.x;
  const int t = tid % Tn, g = (tid / Tn) % G, n = tid / (Tn * G);
  const int C = hd / V;            // chunks of a head row
  const int rot = t % C;           // this thread's first chunk
  const int ustride = NT * G * hd;  // frame u to u + 1 of one (location, head)
  const int col = (n * G + g) * hd;  // (location, head)'s row of frame 0
  const int own = t * ustride + col;  // this thread's row
  const uint32_t box = uint32_t(Tn) * ustride * sizeof(T);

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) hp::mbar_init(&full[s], 1);
    hp::mbar_init_fence();
  }
  __syncthreads();
  // a tile's box coordinates: head group, first location, first (b, t) row
  auto coords = [&](long tile) {
    return int3{int(tile % h_tiles), int((tile / h_tiles) % n_tiles) * NT,
                int(tile / (long(h_tiles) * n_tiles)) * Tn};
  };
  auto load = [&](long tile, int s) {
    const int3 at = coords(tile);
    hp::mbar_expect_tx(&full[s], 3 * box);
    for (int w = 0; w < 3; ++w)
      hp::tma_load_5d(stage(s) + w * region, &in_map, &full[s], 0, at.x, w, at.y, at.z);
  };
  const long first = blockIdx.x, step = gridDim.x;
  if (tid == 0) {
    for (int s = 0; s < kStages && first + s * step < tiles; ++s) load(first + s * step, s);
  }

  int k = 0;
  for (long tile = first; tile < tiles; tile += step, ++k) {
    const int s = k % kStages;
    hp::mbar_wait(&full[s], (k / kStages) & 1);
    T* qs = reinterpret_cast<T*>(stage(s));
    const T* ks = reinterpret_cast<const T*>(stage(s) + region) + col;
    const T* vs = reinterpret_cast<const T*>(stage(s) + 2 * region) + col;

    // frames u >= Tn (TMAX > Tn) read row Tn - 1 and are masked after the
    // scores, so no loop below branches and a chunk's TMAX loads issue
    // together
    float sc[TMAX];  // scores, then p
#pragma unroll
    for (int u = 0; u < TMAX; ++u) sc[u] = 0.0f;
    for (int j = 0; j < C; ++j) {
      const int c = (j + rot < C ? j + rot : j + rot - C) * V;
      float q[V];
      widen<T>(*reinterpret_cast<const uint4*>(qs + own + c), q);
#pragma unroll
      for (int i = 0; i < V; ++i) q[i] *= scale;
#pragma unroll
      for (int u = 0; u < TMAX; ++u) {
        float kf[V];
        widen<T>(*reinterpret_cast<const uint4*>(ks + (u < Tn ? u : Tn - 1) * ustride + c), kf);
        float a = sc[u];
#pragma unroll
        for (int i = 0; i < V; ++i) a = fmaf(q[i], kf[i], a);
        sc[u] = a;
      }
    }
    float mx = -INFINITY;
#pragma unroll
    for (int u = 0; u < TMAX; ++u) mx = fmaxf(mx, u < Tn ? sc[u] : -INFINITY);
    float l = 0.0f;
#pragma unroll
    for (int u = 0; u < TMAX; ++u) {
      sc[u] = u < Tn ? expf(sc[u] - mx) : 0.0f;
      l += sc[u];
    }
    // o / l: q0 = o r with r = 1/l rounded, then one fma correction, which
    // gives the correctly rounded quotient (Markstein) without a division
    // per value
    const float r = __frcp_rn(l);
    for (int j = 0; j < C; ++j) {
      const int c = (j + rot < C ? j + rot : j + rot - C) * V;
      float o[V];
#pragma unroll
      for (int i = 0; i < V; ++i) o[i] = 0.0f;
#pragma unroll
      for (int u = 0; u < TMAX; ++u) {
        float vf[V];
        widen<T>(*reinterpret_cast<const uint4*>(vs + (u < Tn ? u : Tn - 1) * ustride + c), vf);
#pragma unroll
        for (int i = 0; i < V; ++i) o[i] = fmaf(sc[u], vf[i], o[i]);
      }
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float q0 = o[i] * r;
        o[i] = fmaf(fmaf(-q0, l, o[i]), r, q0);
      }
      *reinterpret_cast<uint4*>(qs + own + c) = narrow<T>(o);  // over this thread's q row
    }
    hp::fence_proxy_async();  // the output rows, before the TMA store reads them
    __syncthreads();          // and every thread is done with the stage
    if (tid == 0) {
      const int3 at = coords(tile);
      hp::tma_store_4d(&out_map, qs, 0, at.x, at.y, at.z);
      hp::bulk_commit();
      if (tile + kStages * step < tiles) {
        hp::bulk_wait_read<0>();  // the store has read the stage
        load(tile + kStages * step, s);
      }
    }
  }
  if (tid == 0) hp::bulk_wait<0>();
}

template <typename T> constexpr CUtensorMapDataType map_type() {
  return sizeof(T) == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
}

// the fast path at T <= TMAX; returns a cudaError_t
template <typename T, int TMAX>
int launch_fast(const void* qkv, void* out, int B, int Tn, int N, int H, int hd, float scale,
                int device, cudaStream_t stream) {
  constexpr int e = int(sizeof(T));
  const int rows = fast_rows(Tn, hd, e);
  // heads per tile: the largest of 4, 3, 2 that divides H, fits the rows and
  // keeps a tile's G·hd channels, one contiguous run, within a TMA box row
  int G = 1;
  for (int c = 4; c > 1 && G == 1; --c)
    if (c <= rows && H % c == 0 && c * hd <= 256) G = c;
  const int NT = rows / G;
  const size_t region = fast_region(Tn, hd, e), smem = fast_smem(Tn, hd, e);
  // the maps' innermost dimension is a head group's G·hd channels
  const cuuint64_t D = cuuint64_t(H) * hd, W = cuuint64_t(G) * hd;
  const cuuint64_t in_dims[5] = {W, cuuint64_t(H / G), 3, cuuint64_t(N), cuuint64_t(B) * Tn};
  const cuuint64_t in_strides[4] = {W * e, D * e, 3 * D * e, N * 3 * D * e};
  const cuuint32_t in_box[5] = {cuuint32_t(W), 1, 1, cuuint32_t(NT), cuuint32_t(Tn)};
  const cuuint64_t out_dims[4] = {W, cuuint64_t(H / G), cuuint64_t(N), cuuint64_t(B) * Tn};
  const cuuint64_t out_strides[3] = {W * e, D * e, N * D * e};
  const cuuint32_t out_box[4] = {cuuint32_t(W), 1, cuuint32_t(NT), cuuint32_t(Tn)};
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  CUtensorMap in_map, out_map;
  if (hp::encode_tensor_map(&in_map, map_type<T>(), 5, const_cast<void*>(qkv), in_dims,
                            in_strides, in_box, ones, CU_TENSOR_MAP_SWIZZLE_NONE) !=
          CUDA_SUCCESS ||
      hp::encode_tensor_map(&out_map, map_type<T>(), 4, out, out_dims, out_strides, out_box,
                            ones, CU_TENSOR_MAP_SWIZZLE_NONE) != CUDA_SUCCESS)
    return int(cudaErrorInvalidValue);
  auto kernel = temporal_attn_tma<T, TMAX>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const int threads = Tn * NT * G;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (err != cudaSuccess) return int(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return int(err);
  const int n_tiles = (N + NT - 1) / NT, h_tiles = H / G;
  const long tiles = long(B) * n_tiles * h_tiles;
  const unsigned grid = unsigned(std::min(tiles, long(std::max(per_sm, 1)) * sms));
  kernel<<<grid, threads, smem, stream>>>(in_map, out_map, Tn, hd, NT, G, n_tiles, h_tiles, tiles,
                                          int(region), scale);
  return int(cudaGetLastError());
}

// Lane l: channels c = l + 32 i (i < VPC, c < hd) and scores u = l + 32 j
// (j < SPL, u < Tn); wpb warps per block.
template <typename T, int VPC, int SPL>
__global__ void __launch_bounds__(kThreads)
temporal_attn_wide(const T* __restrict__ qkv, T* __restrict__ out, int B, int Tn, int N, int H,
                   int hd, int wpb, float scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long gw = long(blockIdx.x) * wpb + warp;
  if (gw >= long(B) * N * H) return;
  const int h = int(gw % H);
  const int n = int((gw / H) % N);
  const int b = int(gw / (long(H) * N));
  const int D = H * hd;
  const long ld = 3L * D;

  extern __shared__ __align__(16) float tsmem[];
  float* kf = tsmem + size_t(warp) * 2 * Tn * hd;  // (Tn, hd), lane-private columns
  float* vf = kf + Tn * hd;

  auto row = [&](int u) { return qkv + ((long(b) * Tn + u) * N + n) * ld; };
  for (int u = 0; u < Tn; ++u) {
    const T* r = row(u);
#pragma unroll
    for (int i = 0; i < VPC; ++i) {
      const int c = lane + 32 * i;
      if (c < hd) {
        kf[u * hd + c] = alpro::to_f32(r[D + h * hd + c]);
        vf[u * hd + c] = alpro::to_f32(r[2 * D + h * hd + c]);
      }
    }
  }

  for (int t = 0; t < Tn; ++t) {
    float q[VPC];
    const T* r = row(t);
#pragma unroll
    for (int i = 0; i < VPC; ++i) {
      const int c = lane + 32 * i;
      q[i] = c < hd ? alpro::to_f32(r[h * hd + c]) * scale : 0.0f;
    }
    float s[SPL];  // lane l holds scores (t, l + 32 j)
#pragma unroll
    for (int j = 0; j < SPL; ++j) {
      s[j] = -INFINITY;
      for (int v = 0; v < 32 && 32 * j + v < Tn; ++v) {
        const int u = 32 * j + v;
        float part = 0.0f;
#pragma unroll
        for (int i = 0; i < VPC; ++i) {
          const int c = lane + 32 * i;
          if (c < hd) part = fmaf(q[i], kf[u * hd + c], part);
        }
        part = alpro::warp_sum(part);
        if (lane == v) s[j] = part;
      }
    }
    float mx = s[0];
#pragma unroll
    for (int j = 1; j < SPL; ++j) mx = fmaxf(mx, s[j]);
    mx = alpro::warp_max(mx);
    float p[SPL], l = 0.0f;
#pragma unroll
    for (int j = 0; j < SPL; ++j) {
      p[j] = 32 * j + lane < Tn ? expf(s[j] - mx) : 0.0f;
      l += p[j];
    }
    l = alpro::warp_sum(l);
    float o[VPC];
#pragma unroll
    for (int i = 0; i < VPC; ++i) o[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < SPL; ++j)
      for (int v = 0; v < 32 && 32 * j + v < Tn; ++v) {
        const int u = 32 * j + v;
        const float pu = __shfl_sync(0xffffffffu, p[j], v);
#pragma unroll
        for (int i = 0; i < VPC; ++i) {
          const int c = lane + 32 * i;
          if (c < hd) o[i] = fmaf(pu, vf[u * hd + c], o[i]);
        }
      }
    T* orow = out + ((long(b) * Tn + t) * N + n) * D + h * hd;
#pragma unroll
    for (int i = 0; i < VPC; ++i) {
      const int c = lane + 32 * i;
      if (c < hd) orow[c] = alpro::from_f32<T>(o[i] / l);
    }
  }
}

template <typename T, int VPC, int SPL>
int launch_wide(const void* qkv, void* out, int B, int Tn, int N, int H, int hd, float scale,
                int device, cudaStream_t stream) {
  const size_t per_warp = 2 * size_t(Tn) * hd * sizeof(float);
  const size_t limit = size_t(alpro::max_smem_optin(device));
  if (per_warp > limit) return int(cudaErrorInvalidValue);
  const int wpb = int(std::min<size_t>(kWarps, limit / per_warp));
  const size_t smem = wpb * per_warp;
  cudaError_t err = cudaFuncSetAttribute(temporal_attn_wide<T, VPC, SPL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         int(smem));
  if (err != cudaSuccess) return int(err);
  const long warps = long(B) * N * H;
  const unsigned blocks = unsigned((warps + wpb - 1) / wpb);
  temporal_attn_wide<T, VPC, SPL><<<blocks, wpb * 32, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<T*>(out), B, Tn, N, H, hd, wpb, scale);
  return int(cudaGetLastError());
}

template <typename T, int VPC>
int dispatch_wide(const void* qkv, void* out, int B, int Tn, int N, int H, int hd, float scale,
                  int device, cudaStream_t s) {
  switch ((Tn + 31) / 32) {
    case 1: return launch_wide<T, VPC, 1>(qkv, out, B, Tn, N, H, hd, scale, device, s);
    case 2: return launch_wide<T, VPC, 2>(qkv, out, B, Tn, N, H, hd, scale, device, s);
    case 3: return launch_wide<T, VPC, 3>(qkv, out, B, Tn, N, H, hd, scale, device, s);
    case 4: return launch_wide<T, VPC, 4>(qkv, out, B, Tn, N, H, hd, scale, device, s);
    default: return int(cudaErrorInvalidValue);
  }
}

// the dynamic shared memory of the launch at (T, hd) on this device, 0 where
// none fits: the fast path's where it applies and its two stages fit, else
// the wide path's warps' fp32 K and V
template <typename T> size_t launch_smem(int Tn, int hd, int device) {
  const size_t optin = size_t(alpro::max_smem_optin(device));
  if (Tn <= kFastMaxT && fast_smem(Tn, hd, sizeof(T)) <= optin) return fast_smem(Tn, hd, sizeof(T));
  const size_t per_warp = 2 * size_t(Tn) * hd * sizeof(float);
  return per_warp > optin ? 0 : std::min<size_t>(kWarps, optin / per_warp) * per_warp;
}

template <typename T>
int dispatch(const void* qkv, void* out, int B, int Tn, int N, int H, int hd, float scale,
             int device, cudaStream_t s) {
  if (Tn <= kFastMaxT &&
      fast_smem(Tn, hd, sizeof(T)) <= size_t(alpro::max_smem_optin(device))) {
    if (Tn <= 8) return launch_fast<T, 8>(qkv, out, B, Tn, N, H, hd, scale, device, s);
    if (Tn <= 16) return launch_fast<T, 16>(qkv, out, B, Tn, N, H, hd, scale, device, s);
    return launch_fast<T, 32>(qkv, out, B, Tn, N, H, hd, scale, device, s);
  }
  switch ((hd + 31) / 32) {
    case 1: return dispatch_wide<T, 1>(qkv, out, B, Tn, N, H, hd, scale, device, s);
    case 2: return dispatch_wide<T, 2>(qkv, out, B, Tn, N, H, hd, scale, device, s);
    case 3: return dispatch_wide<T, 3>(qkv, out, B, Tn, N, H, hd, scale, device, s);
    case 4: return dispatch_wide<T, 4>(qkv, out, B, Tn, N, H, hd, scale, device, s);
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace tattn
}  // namespace alpro
