// Masked multi-head attention on strided q, k, v: one kernel for the
// (B, S, H·hd) and (B, H, S, hd) layouts.
//
// Replaces the TPU kernels alpro_tpu/ops/pallas_attn.py::fused_attention_bshd
// (_attn_kernel_heads) and ::fused_attention (_attn_kernel), which share one
// body. Contract kept from them, tiling not:
//   * q, k, v and the output are read and written in place through their
//     (sequence, head, batch) strides, head_dim contiguous: the packed
//     [q | k | v] projection and the flat (B, S, H·hd) channels need no
//     head-split copies, and (B, H, S, hd) is the same kernel with other
//     strides;
//   * scores are q·kᵀ on the stored operands with fp32 accumulation, times the
//     scale, plus the fp32 key bias (1 - mask)·-10000; the row max and the exp
//     are fp32 over the Sk keys (keys past Sk never contribute: the TPU's pad
//     to 128 with -1e9 is tiling only); the unnormalised p is rounded to v's
//     dtype for P·V with fp32 accumulation; the division by the fp32 row sum
//     comes last, then the cast to the output dtype.
//
// What bounds it on an H100: per (sequence, head) two Sq x Sk x hd products
// over (Sq + 2 Sk)·hd operands, 10 MFLOP over 75 KB at S = 197; at the
// spatial shape (64 frames x 12 heads) the least time is set by the bytes
// (78 MB, 23 us, against 8 us of bf16 tensor-core work).
//
// bf16 is K1's body (attn_wgmma.cuh, whose comment gives the design) with a
// key bias: each of q, k and v gets a 4-D TMA map {hd, S, H, B} from its own
// byte strides, so Sq and Sk differ freely; the bias (1 - mask)·-10000 of the
// sequence's key mask is staged in shared memory once per CTA and added to
// the scaled scores in registers (without a mask the bias is 0: K1's body
// as it is); query tiles are split over grid z where B·H CTAs alone would
// leave the card idle. Shared memory bounds only the bias row (20 480 keys
// at hd = 64): K and V stream through a ring of TMA slots past what fits.
//
// fp32 inputs have no tensor-core product that keeps fp32 operands (TF32
// would change the products), so they take a CUDA-core body (warp_tile.cuh):
// one block per (query tile, head, sequence) stages the head's K and V (Sk x
// hd, zero past Sk) and the key bias in shared memory; each warp owns 16
// query rows and walks the keys in chunks of 64 twice — first for the exact
// fp32 row max, then for p = exp(s - max), whose sum stays fp32 while P·V
// accumulates in registers across chunks. K and V of one head bound Sk (416
// keys at hd = 64 on an H100); it is a test and training dtype.
#include "attn_wgmma.cuh"

namespace {

// ---- fp32 body (CUDA cores) ----

constexpr int kKC = 64;        // keys per chunk
constexpr int kMaxWarps = 8;   // 16 query rows per warp
constexpr int kLdP = kKC + 8;  // p chunk leading dimension (elements)

// fp32 score chunk, and at the end the 16 x hd output tile, leading dimension
template <int HD> __host__ __device__ constexpr int ld_scores() {
  return (kKC > HD ? kKC : HD) + 4;
}

template <int HD>
size_t smem_bytes(int SKP, int warps) {
  return 2 * size_t(SKP) * HD * 4             // K, V of the head
         + size_t(warps) * 16 * HD * 4         // Q tile
         + size_t(SKP) * 4                     // key bias
         + size_t(warps) * 16 * ld_scores<HD>() * 4  // per-warp score chunk
         + size_t(warps) * 16 * kLdP * 4;      // per-warp p chunk
}

// s = Q (16 x HD) · K_chunkᵀ for nt 16-key tiles, stored at Sc
template <int HD>
__device__ __forceinline__ void score_chunk(const float* Qw, const float* Kc, int nt, float* Sc) {
  for (int j = 0; j < nt; ++j) {
    alpro::WarpTile<float> acc;
    acc.zero();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      acc.template mma<true>(Qw + kk * 16, HD, Kc + j * 16 * HD + kk * 16, HD);
    acc.store(Sc + j * 16, ld_scores<HD>());
  }
}

template <int HD>
__global__ void __launch_bounds__(kMaxWarps * 32)
masked_attn_f32(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ mask,
                float* __restrict__ out, alpro::attn::Strides sq, alpro::attn::Strides sk,
                alpro::attn::Strides sv, alpro::attn::Strides so, int Sq, int Sk, int SKP,
                float scale) {
  constexpr int kLdS = ld_scores<HD>();
  constexpr int kCpr = HD / 4;  // 16-byte chunks per head row
  const int warps = blockDim.x >> 5, QT = warps * 16;
  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + SKP * HD;
  float* Qs = Vs + SKP * HD;
  float* bs = Qs + QT * HD;
  float* Sc = bs + SKP + warp * 16 * kLdS;
  float* Pc = bs + SKP + warps * 16 * kLdS + warp * 16 * kLdP;

  // ---- stage K, V (SKP rows, zero past Sk), the Q tile and the key bias ----
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  for (int i = threadIdx.x; i < SKP * kCpr; i += blockDim.x) {
    const int r = i / kCpr, c = i % kCpr;
    uint4 kv = make_uint4(0, 0, 0, 0), vv = kv;
    if (r < Sk) {
      kv = reinterpret_cast<const uint4*>(kb + r * sk.s)[c];
      vv = reinterpret_cast<const uint4*>(vb + r * sv.s)[c];
    }
    reinterpret_cast<uint4*>(Ks + r * HD)[c] = kv;
    reinterpret_cast<uint4*>(Vs + r * HD)[c] = vv;
  }
  const float* qb = q + b * sq.b + h * sq.h;
  for (int i = threadIdx.x; i < QT * kCpr; i += blockDim.x) {
    const int r = i / kCpr, c = i % kCpr, s = q0 + r;
    uint4 qv = make_uint4(0, 0, 0, 0);
    if (s < Sq) qv = reinterpret_cast<const uint4*>(qb + s * sq.s)[c];
    reinterpret_cast<uint4*>(Qs + r * HD)[c] = qv;
  }
  for (int c = threadIdx.x; c < SKP; c += blockDim.x)  // the twin's key_bias
    bs[c] = c < Sk && mask ? (1.0f - mask[long(b) * Sk + c]) * -10000.0f : 0.0f;
  __syncthreads();

  const int r0 = warp * 16;
  if (q0 + r0 >= Sq) return;  // no valid query row in this warp (no block syncs follow)
  const float* Qw = Qs + r0 * HD;
  // lane (row, half) owns chunk columns 2i + half of row `row`
  const int row = lane >> 1, half = lane & 1;

  // ---- pass 1: the fp32 row max of s·scale + bias over the Sk keys ----
  float mx = -INFINITY;
  for (int c0 = 0; c0 < SKP; c0 += kKC) {
    score_chunk<HD>(Qw, Ks + c0 * HD, min(kKC, SKP - c0) / 16, Sc);
    __syncwarp();
    for (int i = 0; i < kKC / 2; ++i) {
      const int c = 2 * i + half;
      if (c0 + c < Sk) mx = fmaxf(mx, Sc[row * kLdS + c] * scale + bs[c0 + c]);
    }
    __syncwarp();
  }
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));

  // ---- pass 2: p = exp(s - max); l += p; o += p · V ----
  alpro::WarpTile<float> acc[HD / 16];
#pragma unroll
  for (int jj = 0; jj < HD / 16; ++jj) acc[jj].zero();
  float l = 0.0f;
  for (int c0 = 0; c0 < SKP; c0 += kKC) {
    const int nt = min(kKC, SKP - c0) / 16;
    score_chunk<HD>(Qw, Ks + c0 * HD, nt, Sc);
    __syncwarp();
    for (int i = 0; i < kKC / 2; ++i) {
      const int c = 2 * i + half;
      float p = 0.0f;
      if (c0 + c < Sk) {
        p = expf(Sc[row * kLdS + c] * scale + bs[c0 + c] - mx);
        l += p;
      }
      Pc[row * kLdP + c] = p;
    }
    __syncwarp();
#pragma unroll
    for (int jj = 0; jj < HD / 16; ++jj)
      for (int j = 0; j < nt; ++j)
        acc[jj].template mma<false>(Pc + j * 16, kLdP, Vs + (c0 + j * 16) * HD + jj * 16, HD);
    __syncwarp();
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);

  // ---- o / l, through the score chunk ----
#pragma unroll
  for (int jj = 0; jj < HD / 16; ++jj) acc[jj].store(Sc + jj * 16, kLdS);
  __syncwarp();
  const int s = q0 + r0 + row;
  if (s < Sq) {
    float* orow = out + b * so.b + s * so.s + h * so.h;
    for (int c = half * (HD / 2); c < (half + 1) * (HD / 2); ++c)
      orow[c] = Sc[row * kLdS + c] / l;
  }
}

// the dynamic shared memory of the smallest fp32 launch (one warp) at Sk
// keys, or 0 past the device's opt-in limit
template <int HD>
int smem_f32(int Sk, int optin) {
  const size_t need = smem_bytes<HD>((Sk + 15) / 16 * 16, 1);
  return need <= size_t(optin) ? int(need) : 0;
}

// an operand's (batch, sequence, head) element strides from its byte strides
// (sequence, head, batch) and element size
alpro::attn::Strides elements(const long long* st, int size) {
  return {st[2] / size, st[0] / size, st[1] / size};
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, const float* mask, void* out,
               const long long* st, int B, int H, int Sq, int Sk, float scale, int device,
               cudaStream_t stream) {
  const int optin = alpro::max_smem_optin(device);
  if (!smem_f32<HD>(Sk, optin)) return int(cudaErrorInvalidValue);
  const int SKP = (Sk + 15) / 16 * 16;
  int warps = min(kMaxWarps, (Sq + 15) / 16);
  while (warps > 1 && smem_bytes<HD>(SKP, warps) > size_t(optin)) --warps;
  const size_t smem = smem_bytes<HD>(SKP, warps);
  cudaError_t err = cudaFuncSetAttribute(masked_attn_f32<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  dim3 grid((Sq + warps * 16 - 1) / (warps * 16), H, B);
  masked_attn_f32<HD><<<grid, warps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      mask, static_cast<float*>(out), elements(st, 4), elements(st + 3, 4), elements(st + 6, 4),
      elements(st + 9, 4), Sq, Sk, SKP, scale);
  return int(cudaGetLastError());
}

// ---- bf16 body: attn_wgmma.cuh with the key bias (none without a mask) ----

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, const float* mask, void* out,
                const long long* st, int B, int H, int Sq, int Sk, float scale, int device,
                cudaStream_t stream) {
  using alpro::attn::Operand;
  const Operand oq{q, st[0], st[1], st[2]}, ok{k, st[3], st[4], st[5]},
      ov{v, st[6], st[7], st[8]};
  const alpro::attn::Strides so = elements(st + 9, 2);
  if (!mask)
    return alpro::attn::launch<HD, false, false>(oq, ok, ov, out, so, nullptr, nullptr, nullptr,
                                                 B, H, Sq, Sk, scale, 1, device, stream);
  return alpro::attn::launch<HD, false, true>(oq, ok, ov, out, so, mask, nullptr, nullptr, B, H,
                                              Sq, Sk, scale, 1, device, stream);
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const float* mask, void* out,
           const long long* st, int B, int H, int Sq, int Sk, float scale, int is_bf16,
           int device, cudaStream_t stream) {
  return is_bf16 ? launch_bf16<HD>(q, k, v, mask, out, st, B, H, Sq, Sk, scale, device, stream)
                 : launch_f32<HD>(q, k, v, mask, out, st, B, H, Sq, Sk, scale, device, stream);
}

}  // namespace

// strides: the byte strides of the (sequence, head, batch) axes of q, k, v and
// out, in that order (12 values; ops/masked_attn.py::map_geometry); mask:
// the (B, Sk) fp32 key mask (1: valid), whose bias (1 - mask)·-10000 the
// kernel computes, or null for none. A plan that does not fit or a tensor map
// that does not encode returns cudaErrorInvalidValue.
extern "C" int alpro_masked_attn(const void* q, const void* k, const void* v, const float* mask,
                                 void* out, const long long* strides, int B, int H, int Sq, int Sk,
                                 int hd, float scale, int is_bf16, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch<32>(q, k, v, mask, out, strides, B, H, Sq, Sk, scale, is_bf16, device, s);
    case 64: return launch<64>(q, k, v, mask, out, strides, B, H, Sq, Sk, scale, is_bf16, device, s);
    case 128: return launch<128>(q, k, v, mask, out, strides, B, H, Sq, Sk, scale, is_bf16, device, s);
    default: return int(cudaErrorInvalidValue);
  }
}

// The dynamic shared memory (bytes) of a launch at Sk keys and head_dim hd on
// `device` with a key mask (fp32: its smallest, one warp), or 0 where no
// launch fits: the figure ops/masked_attn.py::smem_bytes gives.
extern "C" int alpro_masked_attn_smem(int Sk, int hd, int is_bf16, int device) {
  if (Sk < 1) return 0;
  const int optin = alpro::max_smem_optin(device);
  switch (hd) {
    case 32: return is_bf16 ? alpro::attn::plan_bf16<32>(Sk, optin, true).smem : smem_f32<32>(Sk, optin);
    case 64: return is_bf16 ? alpro::attn::plan_bf16<64>(Sk, optin, true).smem : smem_f32<64>(Sk, optin);
    case 128: return is_bf16 ? alpro::attn::plan_bf16<128>(Sk, optin, true).smem : smem_f32<128>(Sk, optin);
    default: return 0;
  }
}
