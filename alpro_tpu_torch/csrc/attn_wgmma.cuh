// The bf16 attention body on Hopper, shared by K1 and B6 (csrc/spatial_attn.cu)
// and B12/B13 (csrc/masked_attn.cu).
//
// Contract (all four TPU kernels'): scores are q·kᵀ on the stored bf16
// operands with fp32 accumulation; the scale is applied to the fp32 scores,
// then (kBias) the key's fp32 additive bias; the exact fp32 row max over every
// key is known before any p is rounded; p = exp(s - max) in fp32 and the row
// sum l from the fp32 p; p rounded to bf16 for P·V with fp32 accumulation;
// o / l written in bf16 last. This is not an online (flash) softmax, so the
// result does not depend on how the keys are chunked.
//
// What bounds it on an H100: two Sq x Sk x hd products per (sequence, head)
// over (Sq + 2 Sk)·hd operands; at the model's shapes (S = 197 and 237, hd =
// 64) the bytes set the least time (3.35 TB/s) well above the tensor cores'
// (989 TFLOP/s). So each byte of q, k and v is read once and everything else
// stays on chip. One CTA of one warpgroup per (head, sequence):
//   * q, k and v each come through a 4-D TMA map {hd, S, H, B} built from the
//     operand's own strides, box (P, 16, 1, 1), 128- or 64-byte swizzled:
//     views of a packed [q | k | v] projection, separate (B, S, H·hd) tensors
//     and contiguous (B, H, S, hd) are one form. S is a dimension of each
//     map, so TMA zero-fills rows past Sq and Sk (keys past Sk are masked by
//     select besides);
//   * the head's K and V are staged once for every 64-row query tile of the
//     CTA, the query tiles double-buffered, all completing on mbarriers;
//   * QKᵀ and P·V run on wgmma (m64, A from registers: Q by ldmatrix, then P
//     converted in place from the score accumulators; B from shared memory:
//     K K-major, V MN-major through the transposed-B descriptor);
//   * the 64 x (up to 256) fp32 score rows stay in registers; the row max and
//     sum reduce over the four lanes that share a row;
//   * up to 256 keys (128 at hd = 128) the softmax is one pass; longer rows
//     walk the keys in chunks twice (first the exact row max, then exp, sum
//     and P·V), K and V resident in shared memory where they fit (hd = 64: S
//     <= 768) and streamed through a ring of TMA slots past that;
//   * kBias: the CTA stages its sequence's key bias (1 - mask)·-10000 (Sk
//     fp32, from the key mask) in shared memory once; right after QKᵀ each
//     thread turns the scores it holds into s·scale + bias in place (one FMA
//     each), so the max, p = 2^(x·log2e - max·log2e) and the masking of keys
//     past Sk are those of the unbiased body;
//   * where B·H CTAs would leave resident slots of the card idle (the longest
//     fusion sequence: 1 x 12 heads), the query tiles are split over grid z;
//     each such CTA stages K and V itself and L2 serves the repeats;
//   * kSplit (B17, csrc/block_attn.cu): q and k come as bf16 pairs hi + lo
//     of fp32 values (|y - hi - lo| <= ~2^-16 |y|), and the scores are
//     q_hi·k_hiᵀ + q_hi·k_loᵀ + q_lo·k_hiᵀ, three wgmma chains into the same
//     fp32 accumulators in one stage (q_lo·k_loᵀ, ~2^-16 of |q||k|, is
//     dropped): fp32 q·kᵀ to ~2^-16, where the others take the stored bf16
//     q and k. q_hi is in registers as above; q_lo stays in shared memory
//     beside it and is read by descriptor (the shared-A wgmma), so the score
//     stage needs no more registers. A K slot holds k_hi, v and k_lo. To
//     keep two CTAs on an SM at the ViT's 197 keys, the one query buffer
//     (q_hi and q_lo) is refilled after its tile's last product, and a
//     single chunk's slot holds its keys rounded up to 16 rows, not 64: the
//     last 64-key block's wgmmas read past a panel into the next one (k_hi
//     into v, v into k_lo, k_lo into a pad after the slots), rows whose
//     scores are masked and whose p are 0 (v's over-read rows are k_lo's,
//     finite);
//   * kPSplit (B7, csrc/qkv_proj.cu; with kSplit B9, csrc/fused_block.cu):
//     their contracts keep p in fp32 for P·V, so p leaves the fp32 score
//     registers as a pair p_hi = bf16(p), p_lo = bf16(p - p_hi) (p to
//     ~2^-16), and P·V = p_hi·v + p_lo·v, two wgmma chains into the same o;
//     l stays the fp32 sum of the unrounded p. To fit the p_lo fragments in
//     registers, each 64-key block's P·V is its own commit group, waited for
//     after the next block's is issued, and q is read from its buffer by
//     descriptor (the buffer is refilled after the tile's last product)
//     instead of being held as fragments. Under kSplit
//     too, v comes as v_hi + v_lo as well and P·V = p_hi·v_hi + p_hi·v_lo +
//     p_lo·v_hi (p_lo·v_lo, ~2^-16 of |p||v|, dropped), so neither p nor v
//     is rounded at the contract's 2^-8. A K slot then holds k_hi, v_hi,
//     v_lo and k_lo in that order (each panel's over-read rows are the next
//     panel's: finite values under p = 0, and k_lo's, whose scores are
//     masked, the pad's); past one chunk of 256 keys its chunks are 128
//     keys, so a ring of two 64 KB slots fits beside the query buffer.
#pragma once

#include "hopper.cuh"
#include "warp_tile.cuh"

// Each translation unit that includes this gets its own kernels (an unnamed
// namespace): K1's and the masked attention's instantiations never share a
// symbol between two modules.
namespace alpro {
namespace attn {
namespace {

using bf16 = __nv_bfloat16;
namespace hp = alpro::hopper;

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxSlots = 30;  // K/V slots: barriers fit the first 256 bytes

// kSplit: the maps of q_lo and k_lo; kVLo (kSplit and kPSplit): and of v_lo
template <bool kSplit, bool kVLo> struct LoMaps {};
template <> struct LoMaps<true, false> {
  CUtensorMap q, k;
};
template <> struct LoMaps<true, true> {
  CUtensorMap q, k, v;
};

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

// the staged bias row: n chunks of R keys in fp32, padded to 1024 bytes so
// the K/V slots after it stay aligned for the swizzle
__host__ __device__ inline long bias_bytes(int n, int R) {
  return (long(n) * R * 4 + 1023) / 1024 * 1024;
}

struct Plan {
  int n = 0;        // key chunks
  int R = 0;        // rows per chunk in shared memory (multiple of 64; kSplit 16)
  int nslots = 0;   // K/V slots (n: resident)
  int smem = 0;     // dynamic shared memory, 0: no launch fits
};

// bias: whether the launch stages a key-bias row; split: kSplit's layout
// (one query buffer of q_hi and q_lo where the others have two of q; K
// slots of k_hi, v and k_lo; one chunk's rows rounded to 16, with a pad for
// the last panel's over-read); vlo (kSplit with kPSplit): a K slot also
// holds v_lo, and past one chunk the chunks are half as long
template <int HD>
Plan plan_bf16(int keys, int smem_optin, bool bias, bool split = false, bool vlo = false) {
  using C = Cfg<HD>;
  Plan p;
  if (keys <= C::kMaxN) {
    p.n = 1;
    p.R = split ? (keys + 15) / 16 * 16 : (keys + 63) / 64 * 64;
  } else {
    p.R = vlo ? C::kMaxN / 2 : C::kMaxN;
    p.n = (keys + p.R - 1) / p.R;
  }
  const long fixed = C::kFixed + (bias ? bias_bytes(p.n, p.R) : 0) +
                     long((p.R + 63) / 64 * 64 - p.R) * C::SW;  // the pad
  const long slot = (vlo ? 4L : split ? 3L : 2L) * p.R * HD * 2;
  long fit = (long(smem_optin) - fixed) / slot;
  if (fit > kMaxSlots) fit = kMaxSlots;
  p.nslots = int(fit < p.n ? fit : p.n);
  if (p.nslots < (p.n > 1 ? 2 : 1)) return Plan{};
  p.smem = int(fixed + p.nslots * slot);
  return p;
}

// The two products of a chunk of NBL 64-key blocks, each one wgmma pipeline
// stage of straight-line code (a branch between a stage's wgmmas would make
// ptxas serialize them). s: this thread's NBL x 32 fp32 accumulators; K and
// V: R-row panels at kb and vb. kSplit: kb holds k_hi, kl k_lo and ql the
// 64-row q_lo tile; the two cross products follow q_hi·k_hiᵀ in the stage.
// kQSS (kPSplit): q (q_hi) is read from its 64-row tile at qh in shared
// memory (A by descriptor), not from the registers qf, which kPSplit's p_lo
// fragments need.
template <int HD, int NBL, bool kSplit, bool kQSS>
__device__ __forceinline__ void qk_stage(float (&s)[NBL * 32],
                                         const uint32_t (&qf)[HD / 16][4],
                                         const unsigned char* kb, const unsigned char* kl,
                                         const unsigned char* ql, const unsigned char* qh,
                                         int R) {
  using C = Cfg<HD>;
  hp::wgmma_fence();
  if constexpr (kQSS) {
    auto desc = [](const unsigned char* base, int off) {
      return hp::smem_desc<C::SW>(base + off, 16, 8 * C::SW);
    };
#pragma unroll
    for (int b = 0; b < NBL; ++b) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int off = (kk * 16 / C::P) * R * C::SW + b * 64 * C::SW + (kk * 16 % C::P) * 2;
        const int aoff = (kk * 16 / C::P) * 64 * C::SW + (kk * 16 % C::P) * 2;
        if (kk == 0) hp::WgmmaSS<64>::run_zero<0>(s + b * 32, desc(qh, aoff), desc(kb, off));
        else hp::WgmmaSS<64>::run<0>(s + b * 32, desc(qh, aoff), desc(kb, off), 1);
        if constexpr (kSplit) {
          hp::WgmmaSS<64>::run<0>(s + b * 32, desc(qh, aoff), desc(kl, off), 1);
          hp::WgmmaSS<64>::run<0>(s + b * 32, desc(ql, aoff), desc(kb, off), 1);
        }
      }
    }
    hp::wgmma_commit();
    hp::wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < NBL * 32; ++i) hp::pin(s[i]);
    return;
  }
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
  if constexpr (kSplit) {
#pragma unroll
    for (int b = 0; b < NBL; ++b) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int off = (kk * 16 / C::P) * R * C::SW + b * 64 * C::SW + (kk * 16 % C::P) * 2;
        hp::WgmmaRS<64>::run<0>(s + b * 32, qf[kk],
                                hp::smem_desc<C::SW>(kl + off, 16, 8 * C::SW), 1);
        const unsigned char* a = ql + (kk * 16 / C::P) * 64 * C::SW + (kk * 16 % C::P) * 2;
        hp::WgmmaSS<64>::run<0>(s + b * 32, hp::smem_desc<C::SW>(a, 16, 8 * C::SW),
                                hp::smem_desc<C::SW>(kb + off, 16, 8 * C::SW), 1);
      }
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

// kPSplit: the P·V of 64-key block b, p_hi·V + p_lo·V (kVLo: + p_hi·v_lo at
// vl) as one commit group, then a wait for the group before it, so only two
// blocks' fragments are live (a whole chunk's p_hi and p_lo would spill)
template <int HD, bool kVLo>
__device__ __forceinline__ void pv_split_block(float (&o)[HD / 2], const uint32_t (&ph)[4][4],
                                               const uint32_t (&pl)[4][4],
                                               const unsigned char* vb, const unsigned char* vl,
                                               int R, int b) {
  using C = Cfg<HD>;
  auto desc = [&](const unsigned char* v, int g) {
    return hp::smem_desc<C::SW>(v + (4 * b + g) * 16 * C::SW, R * C::SW, 8 * C::SW);
  };
  hp::wgmma_fence();
#pragma unroll
  for (int g = 0; g < 4; ++g) hp::WgmmaRS<HD>::template run<1>(o, ph[g], desc(vb, g), 1);
#pragma unroll
  for (int g = 0; g < 4; ++g) hp::WgmmaRS<HD>::template run<1>(o, pl[g], desc(vb, g), 1);
  if constexpr (kVLo) {
#pragma unroll
    for (int g = 0; g < 4; ++g) hp::WgmmaRS<HD>::template run<1>(o, ph[g], desc(vl, g), 1);
  }
  hp::wgmma_commit();
  hp::wgmma_wait<1>();
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
// p rounded to bf16 . V into o (kPSplit: p_hi + p_lo; kVLo: and V's v_lo at
// vl). Columns past `valid` (in the last block) are -inf for the max and 0
// for p. kBias: cb is the chunk's bias row, added to the scaled scores in
// place first.
template <int HD, int NBL, bool kBias, bool kSplit, bool kPSplit>
__device__ __forceinline__ void chunk_step(bool pass2, bool single, int valid, float scale,
                                           int quad, const uint32_t (&qf)[HD / 16][4],
                                           const unsigned char* kb, const unsigned char* vb,
                                           const unsigned char* kl, const unsigned char* vl,
                                           const unsigned char* qbuf, int R, const float* cb,
                                           Rows& st, float (&o)[HD / 2]) {
  float s[NBL * 32];
  qk_stage<HD, NBL, kSplit, kPSplit>(s, qf, kb, kl, qbuf + Cfg<HD>::kQBytes, qbuf, R);
  // register 4 j + e of block b holds column 64 b + 8 j + 2 quad + (e & 1)
  float sc = scale;
  if constexpr (kBias) {
#pragma unroll
    for (int b = 0; b < NBL; ++b) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 kbias = *reinterpret_cast<const float2*>(cb + 64 * b + 8 * j + 2 * quad);
        float* r = s + 32 * b + 4 * j;
        r[0] = fmaf(r[0], scale, kbias.x);
        r[1] = fmaf(r[1], scale, kbias.y);
        r[2] = fmaf(r[2], scale, kbias.x);
        r[3] = fmaf(r[3], scale, kbias.y);
      }
    }
    sc = 1.0f;  // s holds the biased, scaled scores now
  }
  const int lim = valid - 64 * (NBL - 1) - 2 * quad;
  auto masked = [&](int i) {
    return i >= 32 * (NBL - 1) && 8 * ((i >> 2) & 7) + (i & 1) >= lim;
  };
  if (!pass2 || single) {
#pragma unroll
    for (int i = 0; i < NBL * 32; ++i) {
      const float v = masked(i) ? -INFINITY : s[i] * sc;
      if (i & 2) st.mx1 = fmaxf(st.mx1, v);
      else st.mx0 = fmaxf(st.mx0, v);
    }
    if (!pass2) return;
    st.quad_max();
  }
  const float sl2 = sc * kLog2e, ml0 = st.mx0 * kLog2e, ml1 = st.mx1 * kLog2e;
  if constexpr (kPSplit) {
#pragma unroll
    for (int b = 0; b < NBL; ++b) {
      uint32_t ph[4][4], pl[4][4];
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float p[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int i = 32 * b + 8 * g + e;
          p[e] = masked(i) ? 0.0f : ex2(fmaf(s[i], sl2, (i & 2) ? -ml1 : -ml0));
        }
        st.l0 += (p[0] + p[1]) + (p[4] + p[5]);
        st.l1 += (p[2] + p[3]) + (p[6] + p[7]);
#pragma unroll
        for (int f = 0; f < 4; ++f) {  // p_lo = p - p_hi, the first value in the low half
          ph[g][f] = hp::pack_bf16(p[2 * f], p[2 * f + 1]);
          pl[g][f] = hp::pack_bf16(p[2 * f] - __uint_as_float(ph[g][f] << 16),
                                   p[2 * f + 1] - __uint_as_float(ph[g][f] & 0xffff0000u));
        }
      }
      pv_split_block<HD, kSplit>(o, ph, pl, vb, vl, R, b);
    }
    hp::wgmma_wait_all();
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) hp::pin(o[i]);
    return;
  }
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
template <int HD, bool kBias, bool kSplit, bool kPSplit, int NBL = 1>
__device__ __forceinline__ void chunk(int nbl, bool pass2, bool single, int valid, float scale,
                                      int quad, const uint32_t (&qf)[HD / 16][4],
                                      const unsigned char* kb, const unsigned char* vb,
                                      const unsigned char* kl, const unsigned char* vl,
                                      const unsigned char* qbuf, int R, const float* cb, Rows& st,
                                      float (&o)[HD / 2]) {
  if constexpr (NBL <= Cfg<HD>::NB) {
    if (nbl == NBL)
      chunk_step<HD, NBL, kBias, kSplit, kPSplit>(pass2, single, valid, scale, quad, qf, kb, vb,
                                                  kl, vl, qbuf, R, cb, st, o);
    else
      chunk<HD, kBias, kSplit, kPSplit, NBL + 1>(nbl, pass2, single, valid, scale, quad, qf, kb,
                                                 vb, kl, vl, qbuf, R, cb, st, o);
  }
}

// rows [row0, row0 + rows) of head h, sequence b through an operand's 4-D
// map {hd, S, H, B}: boxes of (P, 16, 1, 1), one panel of R rows per P columns
template <int HD> __device__ __forceinline__ void load_rows(
    unsigned char* dst, const CUtensorMap* map, uint64_t* bar, int row0, int rows, int h,
    int b) {
  using C = Cfg<HD>;
  for (int p = 0; p < C::NP; ++p)
    for (int blk = 0; blk < rows / 16; ++blk)
      hp::tma_load_4d(dst + p * rows * C::SW + blk * 16 * C::SW, map, bar, p * C::P,
                      row0 + blk * 16, h, b);
}

// element strides of the output's (batch, sequence, head) axes
struct Strides {
  long long b, s, h;
};

// CTA (head blockIdx.x, sequence m = blockIdx.y) over query tiles
// [blockIdx.z·tpc, +tpc) of 64 rows. nkeys: the keys in the k and v maps;
// nq: the query rows (kCls: N + 1, the CLS query last and not in the q map).
// kCls: qkv_c holds the CLS rows (one per sample of Tn frames), out_c gets the
// CLS query's output (one row per frame). kBias: mask holds one fp32 key-mask
// row of nkeys per sequence (1: a valid key). kSplit: mq and mk are the
// maps of q_hi and k_hi, lo those of q_lo and k_lo. kPSplit: P·V on p_hi +
// p_lo; with kSplit, mv is v_hi's map and lo.v v_lo's.
template <int HD, bool kCls, bool kBias, bool kSplit = false, bool kPSplit = false>
__global__ void __launch_bounds__(128, 1)
attn_wgmma(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
           const __grid_constant__ CUtensorMap mv, bf16* __restrict__ out, Strides so,
           const float* __restrict__ mask, const bf16* __restrict__ qkv_c,
           bf16* __restrict__ out_c, int nkeys, int nq, int H, float scale, int Tn, int n, int R,
           int nslots, int tpc, const __grid_constant__ LoMaps<kSplit, kSplit && kPSplit> lo) {
  static_assert(!(kCls && kBias), "the CLS sideband takes no key bias");
  static_assert(!(kCls && kSplit), "the CLS sideband takes no split operands");
  static_assert(!(kCls && kPSplit), "the CLS sideband keeps its CLS p apart");
  constexpr bool kVLo = kSplit && kPSplit;  // a K slot holds v_lo too
  using C = Cfg<HD>;
  constexpr int QB = (kSplit ? 2 : 1) * C::kQBytes;  // one query buffer (kSplit: hi, lo)
  constexpr int NQB = kSplit ? 1 : 2;                 // query buffers
  constexpr int SW = C::SW, P = C::P;
  const int h = blockIdx.x, m = blockIdx.y, D = H * HD;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, quad = lane & 3;
  const int t0 = blockIdx.z * tpc;
  const int ntiles = min(tpc, (nq + 63) / 64 - t0);

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(base);  // two query buffers
  uint64_t* bar_kv = bar_q + 2;                           // nslots
  float* vcls = reinterpret_cast<float*>(base + 512);     // kCls: the CLS value, fp32
  unsigned char* qbuf = base + 1024;
  unsigned char* kcls = qbuf + NQB * QB;  // kCls: 8-row K block, row 0 the CLS key
  float* bsm = reinterpret_cast<float*>(kcls + C::kClsBytes);  // kBias: n·R bias row
  unsigned char* slots =                                        // nslots x (K, V), R rows
      kcls + C::kClsBytes + (kBias ? bias_bytes(n, R) : 0);
  const int half = R * HD * 2;
  // K (k_hi) and V (v_hi), then kVLo v_lo, then kSplit k_lo
  const int slot_bytes = (kVLo ? 4 : kSplit ? 3 : 2) * half;
  const int kl_at = (kVLo ? 3 : 2) * half;

  const bool resident = n <= nslots;
  const int tile_steps = n > 1 ? 2 * n : 1;  // pass 1 (max), pass 2 (exp, sum, PV)
  const int total_steps = ntiles * tile_steps;

  auto load_q = [&](int t) {
    const int b = kSplit ? 0 : (t & 1);
    uint64_t* bar = &bar_q[b];
    hp::mbar_expect_tx(bar, QB);
    load_rows<HD>(qbuf + b * QB, &mq, bar, (t0 + t) * 64, 64, h, m);
    if constexpr (kSplit)
      load_rows<HD>(qbuf + b * QB + C::kQBytes, &lo.q, bar, (t0 + t) * 64, 64, h, m);
  };
  // chunk c of K (and V) into slot
  auto load_kv = [&](int slot, int c, bool with_v) {
    uint64_t* bar = &bar_kv[slot];
    unsigned char* dst = slots + slot * slot_bytes;
    hp::mbar_expect_tx(bar, ((with_v ? (kVLo ? 3 : 2) : 1) + (kSplit ? 1 : 0)) * half);
    load_rows<HD>(dst, &mk, bar, c * R, R, h, m);
    if (with_v) load_rows<HD>(dst + half, &mv, bar, c * R, R, h, m);
    if constexpr (kVLo)
      if (with_v) load_rows<HD>(dst + 2 * half, &lo.v, bar, c * R, R, h, m);
    if constexpr (kSplit) load_rows<HD>(dst + kl_at, &lo.k, bar, c * R, R, h, m);
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
    if (NQB > 1 && ntiles > 1) load_q(1);
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
  if constexpr (kBias) {  // the twin's key_bias, in the same two fp32 steps
    const float* mrow = mask + long(m) * nkeys;
    for (int i = tid; i < n * R; i += 128) bsm[i] = i < nkeys ? (1.0f - mrow[i]) * -10000.0f : 0.0f;
  }
  __syncthreads();

  int step = 0;
  // acquire the slot of the current step (waits for its TMA)
  auto acquire = [&](int c) -> const unsigned char* {
    const int slot = resident ? c : step % nslots;
    hp::mbar_wait(&bar_kv[slot], resident ? 0 : (step / nslots) & 1);
    return slots + slot * slot_bytes;
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
    unsigned char* qb = qbuf + (kSplit ? 0 : (t & 1)) * QB;
    hp::mbar_wait(&bar_q[kSplit ? 0 : (t & 1)], kSplit ? (t & 1) : ((t >> 1) & 1));
    if (kCls && t0 + t == (nq - 1) / 64) {  // the CLS query is row nq - 1
      const int r = (nq - 1) & 63;
      if (tid < HD / 8) {
        const int p = tid / (P / 8), c = tid % (P / 8);
        *reinterpret_cast<uint4*>(qb + p * 64 * SW + hp::swizzled<SW>(r, c)) =
            *reinterpret_cast<const uint4*>(crow + h * HD + tid * 8);
        hp::fence_proxy_async();
      }
      __syncthreads();
    }
    // this warp's 16 query rows as wgmma A fragments (kPSplit: q stays in
    // its buffer, read by descriptor, until the tile's last product)
    uint32_t qf[HD / 16][4];
    if constexpr (!kPSplit) {
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int c = (kk * 16 % P) / 8 + (lane >> 4);
        hp::ldmatrix_x4(qf[kk], qb + (kk * 16 / P) * 64 * SW + hp::swizzled<SW>(row, c));
      }
      // the ldmatrix reads (generic proxy) ordered before the TMA refill of
      // this buffer (async proxy): without this fence the refill could
      // overtake them (on an H100, 31 of 40 000 repeated (64, 197) B13 calls
      // gave other outputs than the first; with it, none)
      hp::fence_proxy_async();
      __syncthreads();  // the buffer is free for tile t + 2 (kSplit: after the tile)
      if (!kSplit && tid == 0 && t + 2 < ntiles) load_q(t + 2);
    }

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
        chunk<HD, kBias, kSplit, kPSplit>((valid + 63) / 64, pass == 1, n == 1, valid, scale,
                                          quad, qf, kv, kv + half, kv + kl_at, kv + 2 * half,
                                          qb, R, bsm + c * R, st, o);
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
    const int r0 = (t0 + t) * 64 + warp * 16 + (lane >> 2), r1 = r0 + 8;
    auto out_row = [&](int r) -> bf16* {
      if (kCls && r == nq - 1) return out_c + long(m) * D + h * HD;
      return out + m * so.b + r * so.s + h * so.h;
    };
    bf16* o0 = r0 < nq ? out_row(r0) : nullptr;
    bf16* o1 = r1 < nq ? out_row(r1) : nullptr;
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
    if constexpr (kSplit) {  // every product of tile t has read its q_lo
      __syncthreads();
      if (tid == 0 && t + 1 < ntiles) load_q(t + 1);
    } else if constexpr (kPSplit) {  // ... and its q
      __syncthreads();
      if (tid == 0 && t + 2 < ntiles) load_q(t + 2);
    }
  }
}

// a bf16 operand: its base and the byte strides of its (sequence, head,
// batch) axes; head_dim is contiguous
struct Operand {
  const void* p;
  long long s, h, b;
};

// the operand's 4-D map {HD, rows, H, B}, box (P, 16, 1, 1)
template <int HD>
bool encode_operand(CUtensorMap* map, const Operand& x, int rows, int H, int B) {
  using C = Cfg<HD>;
  const cuuint64_t dims[4] = {cuuint64_t(HD), cuuint64_t(rows), cuuint64_t(H), cuuint64_t(B)};
  const cuuint64_t strides[3] = {cuuint64_t(x.s), cuuint64_t(x.h), cuuint64_t(x.b)};
  const cuuint32_t box[4] = {cuuint32_t(C::P), 16, 1, 1}, elem[4] = {1, 1, 1, 1};
  return hp::encode_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x.p),
                               dims, strides, box, elem,
                               C::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                            : CU_TENSOR_MAP_SWIZZLE_64B) == CUDA_SUCCESS;
}

// One launch of attn_wgmma over B sequences of H heads: nq query rows (the
// q map holds nkeys of them when kCls), nkeys keys; out through so (elements).
// kSplit: q and k are q_hi and k_hi, split[0] and split[1] q_lo and k_lo;
// with kPSplit, v is v_hi and split[2] v_lo. A map that does not encode or a
// plan that does not fit returns cudaErrorInvalidValue.
template <int HD, bool kCls, bool kBias, bool kSplit = false, bool kPSplit = false>
int launch(const Operand& q, const Operand& k, const Operand& v, void* out, Strides so,
           const float* mask, const void* qkv_c, void* out_c, int B, int H, int nq, int nkeys,
           float scale, int Tn, int device, cudaStream_t stream,
           const Operand* split = nullptr) {
  constexpr bool kVLo = kSplit && kPSplit;
  const Plan p = plan_bf16<HD>(nkeys, alpro::max_smem_optin(device), kBias, kSplit, kVLo);
  if (!p.smem) return int(cudaErrorInvalidValue);
  CUtensorMap mq, mk, mv;
  if (!encode_operand<HD>(&mq, q, kCls ? nkeys : nq, H, B) ||
      !encode_operand<HD>(&mk, k, nkeys, H, B) || !encode_operand<HD>(&mv, v, nkeys, H, B))
    return int(cudaErrorInvalidValue);
  LoMaps<kSplit, kVLo> lo;
  if constexpr (kSplit) {
    if (!split || !encode_operand<HD>(&lo.q, split[0], nq, H, B) ||
        !encode_operand<HD>(&lo.k, split[1], nkeys, H, B))
      return int(cudaErrorInvalidValue);
  }
  if constexpr (kVLo) {
    if (!encode_operand<HD>(&lo.v, split[2], nkeys, H, B)) return int(cudaErrorInvalidValue);
  }
  auto kernel = attn_wgmma<HD, kCls, kBias, kSplit, kPSplit>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return int(err);
  // query tiles per CTA: all of them, unless B·H CTAs leave the card's
  // resident slots idle; then the query tiles spread over about as many CTAs
  // as the card holds at once. (Rounding up to one whole wave of longer tile
  // ranges instead measured slower on an H100: (2, 1000) 0.074 -> 0.100 ms,
  // (8, 257) 0.054 -> 0.064 ms per call.)
  const long ntiles = (nq + 63) / 64, ctas = long(B) * H;
  long tpc = ntiles;
  if (ntiles > 1) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 128, p.smem);
    if (err != cudaSuccess) return int(err);
    const long resident = long(sms) * (per_sm > 0 ? per_sm : 1);
    tpc = (ntiles * ctas + resident - 1) / resident;
    tpc = tpc < 1 ? 1 : tpc > ntiles ? ntiles : tpc;
  }
  const int splits = int((ntiles + tpc - 1) / tpc);
  tpc = (ntiles + splits - 1) / splits;  // the same splits, balanced
  kernel<<<dim3(H, B, splits), 128, p.smem, stream>>>(
      mq, mk, mv, static_cast<bf16*>(out), so, mask, static_cast<const bf16*>(qkv_c),
      static_cast<bf16*>(out_c), nkeys, nq, H, scale, Tn, p.n, p.R, p.nslots, int(tpc), lo);
  return int(cudaGetLastError());
}

}  // namespace
}  // namespace attn
}  // namespace alpro
