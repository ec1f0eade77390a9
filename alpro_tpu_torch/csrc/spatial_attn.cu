// Spatial (per-frame) attention over packed qkv: (M, S, 3D) -> (M, S, D).
//
// Replaces the TPU kernel alpro_tpu/ops/pallas_qkv_attn.py::fused_attention_qkv
// (_spatial_kernel). Contract kept from it, tiling not:
//   * q, k and v are read in place from the packed [q | k | v] channels (each
//     head-major), by offsets: no head-split copies and no padding of S in
//     device memory;
//   * scores are QK^T on the stored operands with fp32 accumulation, the scale
//     is applied to the fp32 scores, then the exact fp32 row max over every
//     key and p = exp(s - max) in fp32; the row sum l is taken from the fp32
//     p; p is cast to the input dtype for PV (fp32 accumulation) and o / l is
//     written in the input dtype. The max is known before any p is rounded,
//     so this is not an online (flash) softmax and the result does not depend
//     on how the keys are chunked.
//
// The CLS-sideband variant (kCls) replaces the TPU kernel
// pallas_qkv_attn.py::fused_attention_qkv_cls (_spatial_cls_kernel): the
// frame's sequence is [N patches, CLS], where the CLS row is one per-sample
// row of qkv_c (frame m reads row m / T), so the (B, T, 1 + N, 3D) concat is
// never materialized; the CLS query's output goes to out_c. Its one numerical
// difference from K1 is the TPU kernel's contract: the CLS key column's
// probability stays fp32 and is added as p_cls * v_cls in fp32, while the
// patch columns' p is rounded to the input dtype as in K1. Key order is free
// in the sums, so the CLS key is taken last.
//
// What bounds it on an H100: per (frame, head) two S x S x hd products, 10
// MFLOP over 75 KB of q/k/v at S = 197, hd = 64; at the model's shape (64
// frames x 12 heads) the least time is set by the bytes (77 MB of qkv in and
// out: 23 us at 3.35 TB/s, against 8 us of bf16 tensor-core work). So the
// design reads each byte of q, k and v once and keeps everything else on
// chip. bf16 body, one CTA of one warpgroup per (head, frame):
//   * TMA stages the head's K and V (once, for every query tile of the frame)
//     and the 64-row query tiles (double-buffered) straight from the packed
//     channels, 128- or 64-byte swizzled, completing on mbarriers; rows past
//     S are zero-filled by TMA because S is a dimension of the tensor map;
//   * QK^T and PV run on wgmma (m64, A from registers: Q by ldmatrix, then P
//     converted in place from the score accumulators; B from shared memory:
//     K K-major, V MN-major through the transposed-B descriptor);
//   * the 64 x (up to 256) fp32 score rows stay in registers; the row max and
//     sum reduce over the four lanes that share a row;
//   * S up to 256 (128 at hd = 128) is one pass; longer rows walk the keys in
//     chunks twice — first the exact row max, then exp, sum and PV — with K
//     and V resident in shared memory where they fit (hd = 64: S <= 768) and
//     streamed through a ring of TMA slots past that, so shared memory does
//     not bound S;
//   * two CTAs share an SM at S = 197 (83 KB each), so one CTA's loads run
//     under the other's math.
// fp32 inputs have no tensor-core product that keeps fp32 operands (TF32
// would change the products), so they take a CUDA-core body
// (warp_tile.cuh): one block per (64-row query tile, head, frame) walking
// the keys in chunks of 64 the same two passes; it is a test and training
// dtype, not the serving path.
#include "hopper.cuh"
#include "warp_tile.cuh"

namespace {

using bf16 = __nv_bfloat16;
namespace hp = alpro::hopper;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxSlots = 30;  // K/V slots: barriers fit the first 256 bytes

// ---- bf16 body (wgmma) ----

template <int HD> struct Cfg {
  static_assert(HD == 32 || HD == 64 || HD == 128, "head_dim");
  static constexpr int P = HD < 64 ? HD : 64;  // panel width (elements)
  static constexpr int NP = HD / P;            // panels per row
  static constexpr int SW = P * 2;             // swizzle span (bytes)
  static constexpr int kMaxN = HD == 128 ? 128 : 256;  // keys per chunk
  static constexpr int NB = kMaxN / 64;                // 64-key score blocks
  static constexpr int kQBytes = 64 * HD * 2;          // one query tile
  static constexpr int kClsBytes = (8 * HD * 2 + 1023) / 1024 * 1024;
  // 1024 alignment slack + barriers and v_cls + two query tiles + CLS key block
  static constexpr int kFixed = 1024 + 1024 + 2 * kQBytes + kClsBytes;
};

struct Plan {
  int n = 0;        // key chunks
  int R = 0;        // rows per chunk in shared memory (multiple of 64)
  int nslots = 0;   // K/V slots (n: resident)
  int smem = 0;     // dynamic shared memory, 0: no launch fits
};

template <int HD> Plan plan_bf16(int keys, int smem_optin) {
  using C = Cfg<HD>;
  Plan p;
  if (keys <= C::kMaxN) {
    p.n = 1;
    p.R = (keys + 63) / 64 * 64;
  } else {
    p.n = (keys + C::kMaxN - 1) / C::kMaxN;
    p.R = C::kMaxN;
  }
  const long slot = 2L * p.R * HD * 2;
  long fit = (long(smem_optin) - C::kFixed) / slot;
  if (fit > kMaxSlots) fit = kMaxSlots;
  p.nslots = int(fit < p.n ? fit : p.n);
  if (p.nslots < (p.n > 1 ? 2 : 1)) return Plan{};
  p.smem = int(C::kFixed + p.nslots * slot);
  return p;
}

// The two products of a chunk of NBL 64-key blocks, each one wgmma pipeline
// stage of straight-line code (a branch between a stage's wgmmas would make
// ptxas serialize them). s: this thread's NBL x 32 fp32 accumulators; K and
// V: R-row panels at kb and vb.
template <int HD, int NBL>
__device__ __forceinline__ void qk_stage(float (&s)[NBL * 32],
                                         const uint32_t (&qf)[HD / 16][4],
                                         const unsigned char* kb, int R) {
  using C = Cfg<HD>;
  hp::wgmma_fence();
#pragma unroll
  for (int b = 0; b < NBL; ++b) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const unsigned char* p =
          kb + (kk * 16 / C::P) * R * C::SW + b * 64 * C::SW + (kk * 16 % C::P) * 2;
      const uint64_t desc = hp::smem_desc<C::SW>(p, 16, 8 * C::SW);
      if (kk == 0) hp::WgmmaRS<64>::run_zero<0>(s + b * 32, qf[kk], desc);
      else hp::WgmmaRS<64>::run<0>(s + b * 32, qf[kk], desc, 1);
    }
  }
  hp::wgmma_commit();
  hp::wgmma_wait_all();
#pragma unroll
  for (int i = 0; i < NBL * 32; ++i) hp::pin(s[i]);
}

template <int HD, int NBL>
__device__ __forceinline__ void pv_stage(float (&o)[HD / 2], const uint32_t (&pf)[4 * NBL][4],
                                         const unsigned char* vb, int R) {
  using C = Cfg<HD>;
  hp::wgmma_fence();
#pragma unroll
  for (int g = 0; g < 4 * NBL; ++g)
    hp::WgmmaRS<HD>::template run<1>(
        o, pf[g], hp::smem_desc<C::SW>(vb + g * 16 * C::SW, R * C::SW, 8 * C::SW), 1);
  hp::wgmma_commit();
  hp::wgmma_wait_all();
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) hp::pin(o[i]);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// rows r = lane / 4 and r + 8 of this warp's 16 query rows: the running max
// of the scaled scores and the partial sums of p over this thread's columns
struct Rows {
  float mx0, mx1, l0, l1;
  __device__ __forceinline__ void quad_max() {
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
    }
  }
};

// One chunk of NBL 64-key blocks with `valid` keys, all of it straight-line
// code (a branch per key group would keep one group's ex2 from overlapping
// the last one's sums). Pass 1 (pass2 false): the row max only. Pass 2: the
// max too when the chunk is the row's only one, then p = exp(s - max) in fp32
// (as 2^(s·scale·log2e - max·log2e): one FMA and ex2), its partial sums, and
// p rounded to bf16 . V into o. Columns past `valid` (in the last block) are
// -inf for the max and 0 for p.
template <int HD, int NBL>
__device__ __forceinline__ void chunk_step(bool pass2, bool single, int valid, float scale,
                                           int quad, const uint32_t (&qf)[HD / 16][4],
                                           const unsigned char* kb, const unsigned char* vb,
                                           int R, Rows& st, float (&o)[HD / 2]) {
  float s[NBL * 32];
  qk_stage<HD, NBL>(s, qf, kb, R);
  // register i of the last block holds its column 8 * ((i >> 2) & 7) + (i & 1)
  // + 2 * quad
  const int lim = valid - 64 * (NBL - 1) - 2 * quad;
  auto masked = [&](int i) {
    return i >= 32 * (NBL - 1) && 8 * ((i >> 2) & 7) + (i & 1) >= lim;
  };
  if (!pass2 || single) {
#pragma unroll
    for (int i = 0; i < NBL * 32; ++i) {
      const float v = masked(i) ? -INFINITY : s[i] * scale;
      if (i & 2) st.mx1 = fmaxf(st.mx1, v);
      else st.mx0 = fmaxf(st.mx0, v);
    }
    if (!pass2) return;
    st.quad_max();
  }
  const float sl2 = scale * kLog2e, ml0 = st.mx0 * kLog2e, ml1 = st.mx1 * kLog2e;
  uint32_t pf[4 * NBL][4];
#pragma unroll
  for (int g = 0; g < 4 * NBL; ++g) {
    float p[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int i = 8 * g + e;
      p[e] = masked(i) ? 0.0f : ex2(fmaf(s[i], sl2, (i & 2) ? -ml1 : -ml0));
    }
    st.l0 += (p[0] + p[1]) + (p[4] + p[5]);
    st.l1 += (p[2] + p[3]) + (p[6] + p[7]);
#pragma unroll
    for (int f = 0; f < 4; ++f) pf[g][f] = hp::pack_bf16(p[2 * f], p[2 * f + 1]);
  }
  pv_stage<HD, NBL>(o, pf, vb, R);
}

// chunk_step for nbl (1..NB) blocks
template <int HD, int NBL = 1>
__device__ __forceinline__ void chunk(int nbl, bool pass2, bool single, int valid, float scale,
                                      int quad, const uint32_t (&qf)[HD / 16][4],
                                      const unsigned char* kb, const unsigned char* vb, int R,
                                      Rows& st, float (&o)[HD / 2]) {
  if constexpr (NBL <= Cfg<HD>::NB) {
    if (nbl == NBL) chunk_step<HD, NBL>(pass2, single, valid, scale, quad, qf, kb, vb, R, st, o);
    else chunk<HD, NBL + 1>(nbl, pass2, single, valid, scale, quad, qf, kb, vb, R, st, o);
  }
}

// tensor map over the packed qkv viewed (M, rows, 3D): box (P, 16 rows, 1)
template <int HD> __device__ __forceinline__ void load_rows(
    unsigned char* dst, const CUtensorMap* map, uint64_t* bar, int col, int row0, int rows,
    int m) {
  using C = Cfg<HD>;
  for (int p = 0; p < C::NP; ++p)
    for (int b = 0; b < rows / 16; ++b)
      hp::tma_load_3d(dst + p * rows * C::SW + b * 16 * C::SW, map, bar, col + p * C::P,
                      row0 + b * 16, m);
}

// nkeys: the keys held in the tensor map (S, or the N patches when kCls);
// nq: query rows (S, or N + 1 with the CLS query last). kCls: out holds the N
// patch rows per frame, qkv_c the CLS rows (one per sample of Tn frames),
// out_c the CLS outputs (one per frame).
template <int HD, bool kCls>
__global__ void __launch_bounds__(128, 1)
spatial_attn_wgmma(const __grid_constant__ CUtensorMap map, bf16* __restrict__ out,
                   const bf16* __restrict__ qkv_c, bf16* __restrict__ out_c, int nkeys, int nq,
                   int H, float scale, int Tn, int n, int R, int nslots) {
  using C = Cfg<HD>;
  constexpr int SW = C::SW, P = C::P;
  const int h = blockIdx.x, m = blockIdx.y, D = H * HD;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, quad = lane & 3;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(base);  // two query buffers
  uint64_t* bar_kv = bar_q + 2;                           // nslots
  float* vcls = reinterpret_cast<float*>(base + 512);     // kCls: the CLS value, fp32
  unsigned char* qbuf = base + 1024;
  unsigned char* kcls = qbuf + 2 * C::kQBytes;  // kCls: 8-row K block, row 0 the CLS key
  unsigned char* slots = kcls + C::kClsBytes;   // nslots x (K, V), R rows each
  const int half = R * HD * 2;

  const int ntiles = (nq + 63) / 64;
  const bool resident = n <= nslots;
  const int tile_steps = n > 1 ? 2 * n : 1;  // pass 1 (max), pass 2 (exp, sum, PV)
  const int total_steps = ntiles * tile_steps;

  auto load_q = [&](int t) {
    uint64_t* bar = &bar_q[t & 1];
    hp::mbar_expect_tx(bar, C::kQBytes);
    load_rows<HD>(qbuf + (t & 1) * C::kQBytes, &map, bar, h * HD, t * 64, 64, m);
  };
  // chunk c of K (and V) into slot
  auto load_kv = [&](int slot, int c, bool with_v) {
    uint64_t* bar = &bar_kv[slot];
    unsigned char* dst = slots + slot * 2 * half;
    hp::mbar_expect_tx(bar, (with_v ? 2 : 1) * half);
    load_rows<HD>(dst, &map, bar, D + h * HD, c * R, R, m);
    if (with_v) load_rows<HD>(dst + half, &map, bar, 2 * D + h * HD, c * R, R, m);
  };
  // streamed step j: (pass, chunk) and its load
  auto load_step = [&](int j) {
    const int jj = j % tile_steps;
    const bool pass2 = n == 1 || jj >= n;
    load_kv(j % nslots, n == 1 ? 0 : jj % n, pass2);
  };

  if (tid == 0) {
    for (int i = 0; i < 2 + nslots; ++i) hp::mbar_init(&bar_q[i], 1);
    hp::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    load_q(0);
    if (ntiles > 1) load_q(1);
    if (resident)
      for (int c = 0; c < n; ++c) load_kv(c, c, true);
    else
      for (int j = 0; j < nslots && j < total_steps; ++j) load_step(j);
  }
  const bf16* crow = kCls ? qkv_c + long(m / Tn) * 3 * D : nullptr;
  if constexpr (kCls) {
    // the CLS key as row 0 of an 8-row K-major block (row 0 is unswizzled)
    constexpr int kPanelChunks = 8 * SW / 16;
    for (int i = tid; i < C::kClsBytes / 16; i += 128) {
      const int p = i / kPanelChunks, off = i % kPanelChunks;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (p < C::NP && off < SW / 16)
        v = *reinterpret_cast<const uint4*>(crow + D + h * HD + p * P + off * 8);
      *reinterpret_cast<uint4*>(kcls + i * 16) = v;
    }
    for (int i = tid; i < HD; i += 128) vcls[i] = __bfloat162float(crow[2 * D + h * HD + i]);
    hp::fence_proxy_async();
  }
  __syncthreads();

  int step = 0;
  // acquire the slot of the current step (waits for its TMA)
  auto acquire = [&](int c) -> const unsigned char* {
    const int slot = resident ? c : step % nslots;
    hp::mbar_wait(&bar_kv[slot], resident ? 0 : (step / nslots) & 1);
    return slots + slot * 2 * half;
  };
  // release it: every warp's wgmma reads are done; refill it when streaming
  auto release = [&]() {
    if (!resident) {
      __syncthreads();
      if (tid == 0 && step + nslots < total_steps) load_step(step + nslots);
    }
    ++step;
  };

  for (int t = 0; t < ntiles; ++t) {
    unsigned char* qb = qbuf + (t & 1) * C::kQBytes;
    hp::mbar_wait(&bar_q[t & 1], (t >> 1) & 1);
    if (kCls && t == (nq - 1) / 64) {  // the CLS query is row nq - 1
      const int r = (nq - 1) & 63;
      if (tid < HD / 8) {
        const int p = tid / (P / 8), c = tid % (P / 8);
        *reinterpret_cast<uint4*>(qb + p * 64 * SW + hp::swizzled<SW>(r, c)) =
            *reinterpret_cast<const uint4*>(crow + h * HD + tid * 8);
        hp::fence_proxy_async();
      }
      __syncthreads();
    }
    // this warp's 16 query rows as wgmma A fragments
    uint32_t qf[HD / 16][4];
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      const int c = (kk * 16 % P) / 8 + (lane >> 4);
      hp::ldmatrix_x4(qf[kk], qb + (kk * 16 / P) * 64 * SW + hp::swizzled<SW>(row, c));
    }
    __syncthreads();  // the buffer is free for tile t + 2
    if (tid == 0 && t + 2 < ntiles) load_q(t + 2);

    Rows st{-INFINITY, -INFINITY, 0.0f, 0.0f};
    float sc[4];  // kCls: the CLS key's score (column 0, held by quad 0)
    if constexpr (kCls) {
      hp::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const unsigned char* p = kcls + (kk * 16 / P) * 8 * SW + (kk * 16 % P) * 2;
        const uint64_t desc = hp::smem_desc<SW>(p, 16, 8 * SW);
        if (kk == 0) hp::WgmmaRS<8>::run_zero<0>(sc, qf[kk], desc);
        else hp::WgmmaRS<8>::run<0>(sc, qf[kk], desc, 1);
      }
      hp::wgmma_commit();
      hp::wgmma_wait_all();
#pragma unroll
      for (int i = 0; i < 4; ++i) hp::pin(sc[i]);
      if (quad == 0) {
        st.mx0 = sc[0] * scale;
        st.mx1 = sc[2] * scale;
      }
    }

    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
    // pass 1 (several chunks): the exact row max over every key; pass 2
    // (with the max, when the chunk is the only one): p, l and P.V
    for (int pass = n > 1 ? 0 : 1; pass < 2; ++pass) {
      for (int c = 0; c < n; ++c) {
        const int valid = min(R, nkeys - c * R);
        const unsigned char* kv = acquire(c);
        chunk<HD>((valid + 63) / 64, pass == 1, n == 1, valid, scale, quad, qf, kv, kv + half,
                  R, st, o);
        release();
      }
      if (pass == 0) st.quad_max();
    }

    // the CLS key's p stays fp32: in l here and as p_cls * v_cls below
    float pc0 = 0.0f, pc1 = 0.0f;
    if constexpr (kCls) {
      if (quad == 0) {
        pc0 = ex2(fmaf(sc[0], scale * kLog2e, -st.mx0 * kLog2e));
        pc1 = ex2(fmaf(sc[2], scale * kLog2e, -st.mx1 * kLog2e));
        st.l0 += pc0;
        st.l1 += pc1;
      }
      pc0 = __shfl_sync(0xffffffffu, pc0, lane & ~3);
      pc1 = __shfl_sync(0xffffffffu, pc1, lane & ~3);
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      st.l0 += __shfl_xor_sync(0xffffffffu, st.l0, off);
      st.l1 += __shfl_xor_sync(0xffffffffu, st.l1, off);
    }

    // o / l in bf16: rows r0 and r0 + 8, columns 8j + 2 quad (+1)
    const int r0 = t * 64 + warp * 16 + (lane >> 2), r1 = r0 + 8;
    auto out_row = [&](int r) -> bf16* {
      if constexpr (kCls)
        return r == nq - 1 ? out_c + long(m) * D : out + (long(m) * (nq - 1) + r) * D;
      return out + (long(m) * nq + r) * D;
    };
    bf16* o0 = r0 < nq ? out_row(r0) + h * HD : nullptr;
    bf16* o1 = r1 < nq ? out_row(r1) + h * HD : nullptr;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int col = 8 * j + 2 * quad;
      float a = o[4 * j], b = o[4 * j + 1], c = o[4 * j + 2], d = o[4 * j + 3];
      if constexpr (kCls) {
        a += pc0 * vcls[col];
        b += pc0 * vcls[col + 1];
        c += pc1 * vcls[col];
        d += pc1 * vcls[col + 1];
      }
      if (o0) *reinterpret_cast<uint32_t*>(o0 + col) = hp::pack_bf16(a / st.l0, b / st.l0);
      if (o1) *reinterpret_cast<uint32_t*>(o1 + col) = hp::pack_bf16(c / st.l1, d / st.l1);
    }
  }
}

template <int HD, bool kCls>
int launch_bf16(const void* qkv, void* out, const void* qkv_c, void* out_c, int M, int nkeys,
                int nq, int H, float scale, int Tn, int device, cudaStream_t stream) {
  using C = Cfg<HD>;
  const Plan p = plan_bf16<HD>(nkeys, alpro::max_smem_optin(device));
  if (!p.smem) return int(cudaErrorInvalidValue);
  const cuuint64_t threeD = 3ull * H * HD;
  const cuuint64_t dims[3] = {threeD, cuuint64_t(nkeys), cuuint64_t(M)};
  const cuuint64_t strides[2] = {threeD * 2, threeD * 2 * nkeys};
  const cuuint32_t box[3] = {cuuint32_t(C::P), 16, 1}, elem[3] = {1, 1, 1};
  CUtensorMap map;
  if (hp::encode_tensor_map(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(qkv),
                            dims, strides, box, elem,
                            C::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                         : CU_TENSOR_MAP_SWIZZLE_64B) != CUDA_SUCCESS)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(spatial_attn_wgmma<HD, kCls>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return int(err);
  spatial_attn_wgmma<HD, kCls><<<dim3(H, M), 128, p.smem, stream>>>(
      map, static_cast<bf16*>(out), static_cast<const bf16*>(qkv_c), static_cast<bf16*>(out_c),
      nkeys, nq, H, scale, Tn, p.n, p.R, p.nslots);
  return int(cudaGetLastError());
}

// ---- fp32 body (CUDA cores) ----

constexpr int kF32QT = 64, kF32KC = 64;  // query rows per block, keys per chunk

size_t smem_f32(int hd) {
  return (4 * size_t(kF32QT) * hd          // Q tile, K and V chunks, o
          + size_t(kF32QT) * kF32KC        // scores, then p in place
          + 2 * kF32QT) * sizeof(float);  // row max, row sum
}

// S: the sequence length per frame (1 + N when kCls, the CLS row first here)
template <bool kCls>
__global__ void __launch_bounds__(128)
spatial_attn_f32(const float* __restrict__ qkv, float* __restrict__ out,
                 const float* __restrict__ qkv_c, float* __restrict__ out_c, int S, int H, int hd,
                 float scale, int Tn) {
  const int q0 = blockIdx.x * kF32QT, h = blockIdx.y, m = blockIdx.z;
  const int D = H * hd;
  const long ld = 3L * D;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, r0 = warp * 16;

  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + kF32QT * hd;
  float* Vs = Ks + kF32KC * hd;
  float* Os = Vs + kF32KC * hd;
  float* Sc = Os + kF32QT * hd;
  float* mrow = Sc + kF32QT * kF32KC;
  float* lrow = mrow + kF32QT;

  auto in_row = [&](int s) -> const float* {
    if constexpr (kCls)
      return s == 0 ? qkv_c + long(m / Tn) * ld : qkv + (long(m) * (S - 1) + s - 1) * ld;
    return qkv + (long(m) * S + s) * ld;
  };
  auto out_row = [&](int s) -> float* {
    if constexpr (kCls)
      return s == 0 ? out_c + long(m) * D : out + (long(m) * (S - 1) + s - 1) * D;
    return out + (long(m) * S + s) * D;
  };

  const int cpr = hd / 4;  // 16-byte chunks per head row
  for (int i = threadIdx.x; i < kF32QT * cpr; i += 128) {
    const int r = i / cpr, c = i % cpr, s = q0 + r;
    uint4 qv = make_uint4(0, 0, 0, 0);
    if (s < S) qv = reinterpret_cast<const uint4*>(in_row(s) + h * hd)[c];
    reinterpret_cast<uint4*>(Qs + r * hd)[c] = qv;
  }
  for (int i = threadIdx.x; i < kF32QT * hd; i += 128) Os[i] = 0.0f;
  for (int i = threadIdx.x; i < kF32QT; i += 128) {
    mrow[i] = -INFINITY;
    lrow[i] = 0.0f;
  }

  const bool active = q0 + r0 < S;  // the warp has a query row
  const int n = (S + kF32KC - 1) / kF32KC;
  for (int pass = n > 1 ? 0 : 1; pass < 2; ++pass) {
    for (int c = 0; c < n; ++c) {
      const int k0 = c * kF32KC, valid = min(kF32KC, S - k0);
      __syncthreads();  // the previous chunk is consumed
      for (int i = threadIdx.x; i < kF32KC * cpr; i += 128) {
        const int r = i / cpr, cc = i % cpr;
        uint4 kv = make_uint4(0, 0, 0, 0), vv = kv;
        if (r < valid) {
          const float* row = in_row(k0 + r);
          kv = reinterpret_cast<const uint4*>(row + D + h * hd)[cc];
          if (pass) vv = reinterpret_cast<const uint4*>(row + 2 * D + h * hd)[cc];
        }
        reinterpret_cast<uint4*>(Ks + r * hd)[cc] = kv;
        if (pass) reinterpret_cast<uint4*>(Vs + r * hd)[cc] = vv;
      }
      __syncthreads();
      if (!active) continue;
      for (int j = 0; j < kF32KC / 16; ++j) {
        alpro::WarpTile<float> acc;
        acc.zero();
        for (int kk = 0; kk < hd / 16; ++kk)
          acc.mma<true>(Qs + r0 * hd + kk * 16, hd, Ks + j * 16 * hd + kk * 16, hd);
        acc.store(Sc + r0 * kF32KC + j * 16, kF32KC);
      }
      __syncwarp();
      for (int r = r0; r < r0 + 16; ++r) {
        float* srow = Sc + r * kF32KC;
        const int ca = lane, cb = lane + 32;
        const float va = ca < valid ? srow[ca] * scale : -INFINITY;
        const float vb = cb < valid ? srow[cb] * scale : -INFINITY;
        if (pass == 0 || n == 1) {
          const float mx = alpro::warp_max(fmaxf(va, vb));
          if (lane == 0) mrow[r] = fmaxf(mrow[r], mx);
          __syncwarp();
        }
        if (pass == 1) {
          const float mx = mrow[r];
          const float pa = ca < valid ? expf(va - mx) : 0.0f;
          const float pb = cb < valid ? expf(vb - mx) : 0.0f;
          srow[ca] = pa;
          srow[cb] = pb;
          const float l = alpro::warp_sum(pa + pb);
          if (lane == 0) lrow[r] += l;
        }
      }
      __syncwarp();
      if (pass == 1) {
        for (int jj = 0; jj < hd / 16; ++jj) {
          alpro::WarpTile<float> acc;
          acc.load(Os + r0 * hd + jj * 16, hd);
          for (int j = 0; j < kF32KC / 16; ++j)
            acc.mma<false>(Sc + r0 * kF32KC + j * 16, kF32KC, Vs + j * 16 * hd + jj * 16, hd);
          acc.store(Os + r0 * hd + jj * 16, hd);
        }
        __syncwarp();
      }
    }
  }
  if (!active) return;
  for (int r = r0; r < r0 + 16 && q0 + r < S; ++r) {
    float* orow = out_row(q0 + r) + h * hd;
    for (int c = lane; c < hd; c += 32) orow[c] = Os[r * hd + c] / lrow[r];
  }
}

template <bool kCls>
int launch_f32(const void* qkv, void* out, const void* qkv_c, void* out_c, int M, int S, int H,
               int hd, float scale, int Tn, cudaStream_t stream) {
  const size_t smem = smem_f32(hd);
  cudaError_t err = cudaFuncSetAttribute(spatial_attn_f32<kCls>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid((S + kF32QT - 1) / kF32QT, H, M);
  spatial_attn_f32<kCls><<<grid, 128, smem, stream>>>(
      static_cast<const float*>(qkv), static_cast<float*>(out), static_cast<const float*>(qkv_c),
      static_cast<float*>(out_c), S, H, hd, scale, Tn);
  return int(cudaGetLastError());
}

// S: the sequence per frame (K1: S rows; kCls: N = S - 1 patch rows + CLS)
template <bool kCls>
int dispatch(const void* qkv, void* out, const void* qkv_c, void* out_c, int M, int S, int H,
             int hd, float scale, int Tn, int is_bf16, int device, cudaStream_t s) {
  if (!is_bf16) return launch_f32<kCls>(qkv, out, qkv_c, out_c, M, S, H, hd, scale, Tn, s);
  const int nkeys = kCls ? S - 1 : S;
  switch (hd) {
    case 32:
      return launch_bf16<32, kCls>(qkv, out, qkv_c, out_c, M, nkeys, S, H, scale, Tn, device, s);
    case 64:
      return launch_bf16<64, kCls>(qkv, out, qkv_c, out_c, M, nkeys, S, H, scale, Tn, device, s);
    case 128:
      return launch_bf16<128, kCls>(qkv, out, qkv_c, out_c, M, nkeys, S, H, scale, Tn, device, s);
    default:
      return int(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int alpro_spatial_attn(const void* qkv, void* out, int M, int S, int H, int hd,
                                  float scale, int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  return dispatch<false>(qkv, out, nullptr, nullptr, M, S, H, hd, scale, 1, is_bf16, device,
                         static_cast<cudaStream_t>(stream));
}

// qkv_x (M, N, 3D) patch rows and qkv_c (M / T, 1, 3D) CLS rows -> out_x
// (M, N, D) and out_c (M, 1, D); M % T == 0.
extern "C" int alpro_spatial_cls_attn(const void* qkv_x, const void* qkv_c, void* out_x,
                                      void* out_c, int M, int N, int T, int H, int hd,
                                      float scale, int is_bf16, int device, void* stream) {
  if (M < 1 || N < 1 || T < 1 || M % T) return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  return dispatch<true>(qkv_x, out_x, qkv_c, out_c, M, N + 1, H, hd, scale, T, is_bf16, device,
                        static_cast<cudaStream_t>(stream));
}

// The dynamic shared memory (bytes) of a K1 launch at S keys and head_dim hd
// on `device`, or 0 where no launch fits (the limit the wrappers' predicate
// reads; a B6 launch at S = N + 1 needs no more).
extern "C" int alpro_spatial_attn_smem(int S, int hd, int is_bf16, int device) {
  if (S < 1 || (hd != 32 && hd != 64 && hd != 128)) return 0;
  const int optin = alpro::max_smem_optin(device);
  if (!is_bf16) return int(smem_f32(hd)) <= optin ? int(smem_f32(hd)) : 0;
  switch (hd) {
    case 32: return plan_bf16<32>(S, optin).smem;
    case 64: return plan_bf16<64>(S, optin).smem;
    default: return plan_bf16<128>(S, optin).smem;
  }
}
