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
// out: 23 us at 3.35 TB/s, against 8 us of bf16 tensor-core work). The bf16
// body is attn_wgmma.cuh's (TMA, wgmma, score rows in registers; the design
// is described there), which B12/B13 share: the packed qkv reaches it as
// three 4-D tensor maps {hd, S, H, M} at channel offsets 0, D and 2D. Two
// CTAs share an SM at S = 197 (83 KB each), so one CTA's loads run under the
// other's math.
// fp32 inputs have no tensor-core product that keeps fp32 operands (TF32
// would change the products), so they take a CUDA-core body
// (warp_tile.cuh): one block per (64-row query tile, head, frame) walking
// the keys in chunks of 64 the same two passes; it is a test and training
// dtype, not the serving path.
#include "attn_wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

// ---- bf16 body: attn_wgmma.cuh over three maps of the packed qkv ----

// nkeys: the rows per frame in qkv (S, or the N patches when kCls); nq: query
// rows (S, or N + 1 with the CLS query last). kCls: out holds the N patch
// rows per frame, qkv_c the CLS rows (one per sample of Tn frames), out_c
// the CLS outputs (one per frame).
template <int HD, bool kCls>
int launch_bf16(const void* qkv, void* out, const void* qkv_c, void* out_c, int M, int nkeys,
                int nq, int H, float scale, int Tn, int device, cudaStream_t stream) {
  const long long D = 1LL * H * HD, row = 3 * D * 2, frame = row * nkeys;
  const bf16* x = static_cast<const bf16*>(qkv);
  const alpro::attn::Operand q{x, row, HD * 2, frame}, k{x + D, row, HD * 2, frame},
      v{x + 2 * D, row, HD * 2, frame};
  const alpro::attn::Strides so{(kCls ? nq - 1 : nq) * D, D, HD};
  return alpro::attn::launch<HD, kCls, false>(q, k, v, out, so, nullptr, qkv_c, out_c, M, H, nq,
                                              nkeys, scale, Tn, device, stream);
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
    case 32: return alpro::attn::plan_bf16<32>(S, optin, false).smem;
    case 64: return alpro::attn::plan_bf16<64>(S, optin, false).smem;
    default: return alpro::attn::plan_bf16<128>(S, optin, false).smem;
  }
}
