// Raw uint8 frames -> embedded patch tokens:
//   out[f, n] = sum_k norm(patch(f, n))[k] * kernel[k] + bias,
//   raw (frames, H, W, 3) uint8, kernel (p*p*3, D) with rows in (ph, pw, c)
//   order, out (frames, N, D), N = (H / p) * (W / p).
//
// Replaces the TPU kernel alpro_tpu/ops/pallas_preprocess.py::
// fused_patchify_embed (_kernel, with the XLA normalize in front of it).
// Contract kept from the JAX function: each pixel is normalized as
// (v / 255 - mean[c]) / std[c] in fp32 and rounded to the kernel's dtype;
// the product accumulates in fp32; the bias is added in fp32; the output is
// in the kernel's dtype, rounded once. Rows and columns of pixels past a
// whole patch are dropped.
//
// What bounds it on an H100: at 8 clips x 8 frames of 224^2 it is 14.8 GFLOP
// against 9.6 MB of pixels, 1.2 MB of kernel and 19.3 MB of output, so the
// tensor cores bound it (0.015 ms).
//
// bf16: two launches behind the one C call.
//   1. patch_rows: the gather and normalize pass into an (R, K) bf16
//      scratch, R = frames * hp * wp, K = p*p*3: row (f, ph, pw), column
//      (i, j, c) is pixel (ph*p + i, pw*p + j, c) of frame f. A CTA writes
//      32 patch rows, a thread a 16-byte chunk of a row at a time, so each
//      warp's store is 512 contiguous bytes (a walk over bands of pixel
//      rows, each warp's stores spread over a dozen patch rows, took 0.048
//      ms at the main shape against this pass's 0.0175 on an H100 80GB
//      HBM3, profile_serving.py). Each chunk's 8 input bytes are contiguous
//      in one pixel row, read in one 8-byte load where the row's byte
//      stride and the pointer allow and in byte loads where they do not.
//      The normalize is a lookup
//      in a shared table of the 3 x 256 values bf16((v / 255 - mean[c]) /
//      std[c]), each computed once per CTA with IEEE divisions (the build
//      has no fast-math), so the scratch is the normalized patch rows bit
//      for bit. ~29 MB of traffic at the main shape (~0.009 ms at 3.35
//      TB/s): the bytes of the normalized frames the JAX path writes too.
//   2. gemm_wgmma.cuh's kRound (gemm_wgmma_kn): out = rows · kernel + bias,
//      the (K, D) kernel read in place as the MN-major B operand, fp32
//      sums, the bias (fp32, or the layer's bf16 vector widened on load)
//      added in fp32, rounded once into out.
//   Limits: K a multiple of 64 (p a multiple of 8: the GEMM's K chunk and
//   the pass's 8-byte chunks), D of 128, H and W at least p.
//
// fp32 (a test dtype: no tensor-core product keeps fp32 operands): the
// row-tile GEMM of row_tile.cuh on the CUDA cores. One block of 16 warps per
// 32 patches gathers their pixels (each patch row is p*3 contiguous bytes of
// a frame row, read by neighbouring threads), normalizes them into a shared
// (32 x p*p*3) tile, then multiplies it by the kernel in 128 x 128 tiles
// with the D output columns in registers (one 16x16 fp32 tile per warp and
// 128-column group), and writes + bias through a per-warp stage buffer.
// K % 128 == 0 up to 1024, D in (256, 512, 768, 1024).
#include <cstdint>

#include "gemm_wgmma.cuh"
#include "row_tile.cuh"

namespace {

using alpro::WarpTile;
using namespace alpro::rows;
using bf16 = __nv_bfloat16;

struct Norm {
  float mean[3], std[3];
};

// ---- bf16: the patch rows pass ----

constexpr int kRowThreads = 256;
constexpr int kRowsPerCta = 32;  // patch rows a CTA writes

// Step t of a CTA's walk over its rows' 16-byte output chunks: chunk col / 8
// of patch row r = (f, ph, pw), columns col .. col + 7 = (i, j .. j + 7, c)
// with j a multiple of 8 in the row segment of seg = p*3 bytes, so its input
// is 8 contiguous bytes of pixel row ph*p + i. A warp writes 512 contiguous
// bytes of the scratch per store, whole 32-byte sectors.
template <bool kVec8>
__global__ void __launch_bounds__(kRowThreads)
patch_rows(const uint8_t* __restrict__ raw, bf16* __restrict__ rows, int R, int H, int W, int p,
           int hp, int wp, Norm nrm) {
  __shared__ uint16_t lut[3 * 256];  // bf16 bits of the normalized value of (c, v)
  for (int t = threadIdx.x; t < 3 * 256; t += kRowThreads) {
    const int c = t >> 8;
    const bf16 h = __float2bfloat16_rn((float(t & 255) / 255.0f - nrm.mean[c]) / nrm.std[c]);
    lut[t] = *reinterpret_cast<const uint16_t*>(&h);
  }
  __syncthreads();
  const int seg = p * 3, K = p * seg, K8 = K / 8;
  const long W3 = long(W) * 3;
  const int r0 = blockIdx.x * kRowsPerCta;
  const int n = min(kRowsPerCta, R - r0) * K8;
  for (int t = threadIdx.x; t < n; t += kRowThreads) {
    const int r = r0 + t / K8, col = (t % K8) * 8;
    const int i = col / seg, j = col - i * seg;
    const int fph = r / wp, pw = r - fph * wp;
    const int f = fph / hp, ph = fph - f * hp;
    const uint8_t* src = raw + (long(f) * H + ph * p + i) * W3 + pw * seg + j;
    uint32_t lo = 0, hi = 0;
    if constexpr (kVec8) {  // W3 and raw 8-byte aligned, and so is src
      const uint2 v = *reinterpret_cast<const uint2*>(src);
      lo = v.x;
      hi = v.y;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        lo |= uint32_t(src[e]) << (8 * e);
        hi |= uint32_t(src[e + 4]) << (8 * e);
      }
    }
    int c = j % 3;  // seg is a multiple of 3: the channel of src's first byte
    uint32_t v[4];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const uint32_t byte = ((e < 4 ? lo : hi) >> (8 * (e & 3))) & 0xffu;
      const uint32_t h = lut[c * 256 + byte];
      v[e / 2] = e & 1 ? v[e / 2] | (h << 16) : h;
      c = c == 2 ? 0 : c + 1;
    }
    *reinterpret_cast<uint4*>(rows + long(r) * K + col) = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// the rows pass into the (R, K) scratch, then the GEMM over it with the
// (K, D) kernel read in place; bias D values of TV
template <typename TV>
int launch_bf16(const uint8_t* raw, const bf16* kernel, const TV* bias, bf16* rows, bf16* out,
                int frames, int H, int W, int p, int D, const Norm& nrm, cudaStream_t stream) {
  const int hp = H / p, wp = W / p, K = p * p * 3;
  const long R = long(frames) * hp * wp;
  if (!rows || R > 0x7fffffffL) return int(cudaErrorInvalidValue);
  const bool vec8 = (long(W) * 3) % 8 == 0 && reinterpret_cast<uintptr_t>(raw) % 8 == 0;
  auto pass = vec8 ? patch_rows<true> : patch_rows<false>;
  pass<<<unsigned((R + kRowsPerCta - 1) / kRowsPerCta), kRowThreads, 0, stream>>>(
      raw, rows, int(R), H, W, p, hp, wp, nrm);
  const int err = int(cudaGetLastError());
  if (err) return err;
  return alpro::gemm::launch<alpro::gemm::kRound, TV, true>(
      rows, kernel, alpro::gemm::Epilogue{{out}, bias, 0}, int(R), D, K, stream);
}

// ---- fp32: the row tile ----

template <typename T>
size_t smem_bytes(int K) {
  return size_t(kTM) * (K + vec<T>()) * sizeof(T)            // normalized patch tile
         + size_t(kTile) * (kTile + vec<T>()) * sizeof(T)    // kernel tile
         + size_t(kWarps) * 256 * 4;                          // per-warp stage
}

template <typename T, int NG>  // D = NG * 128
__global__ void __launch_bounds__(kThreads, 1)
patchify_embed_kernel(const uint8_t* __restrict__ raw, const T* __restrict__ kernel,
                      const float* __restrict__ bias, T* __restrict__ out, int R, int H, int W,
                      int p, int N, int wp, Norm nrm) {
  constexpr int D = NG * kTile;
  const int K = p * p * 3, seg = p * 3, ldx = K + vec<T>();
  const int r0 = blockIdx.x * kTM;
  const int warp = threadIdx.x >> 5;

  extern __shared__ __align__(128) unsigned char smem[];
  T* xs = reinterpret_cast<T*>(smem);
  T* wt = xs + kTM * ldx;
  float* stage = reinterpret_cast<float*>(wt + kTile * (kTile + vec<T>())) + warp * 256;

  // ---- gather + normalize: column k = (i, j, c) of patch row r is pixel
  //      (ph * p + i, pw * p + j, c); zero past R ----
  for (int e = threadIdx.x; e < kTM * K; e += kThreads) {
    const int r = e / K, k = e % K, row = r0 + r;
    float v = 0.0f;
    if (row < R) {
      const int f = row / N, n = row % N;
      const int i = k / seg, jc = k % seg, c = jc % 3;
      const long pix = (long(f) * H + (n / wp) * p + i) * W * 3 + (n % wp) * seg + jc;
      v = (float(raw[pix]) / 255.0f - nrm.mean[c]) / nrm.std[c];
    }
    xs[r * ldx + k] = alpro::from_f32<T>(v);
  }

  WarpTile<T> acc[NG];
#pragma unroll
  for (int g = 0; g < NG; ++g) acc[g].zero();
  gemm<T, NG, false>(acc, xs, ldx, kernel, D, K / kTile, wt);  // begins with a block sync
  store_rows<T, NG>(acc, stage, bias, nullptr, out, D, 0, r0, R);
}

template <typename T, int NG>
int launch(const void* raw, const void* kernel, const void* bias, void* out, int frames, int H,
           int W, int p, const Norm& nrm, cudaStream_t stream) {
  const int hp = H / p, wp = W / p, N = hp * wp, R = frames * N;
  const size_t smem = smem_bytes<T>(p * p * 3);
  cudaError_t err = cudaFuncSetAttribute(patchify_embed_kernel<T, NG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  patchify_embed_kernel<T, NG><<<(R + kTM - 1) / kTM, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(raw), static_cast<const T*>(kernel),
      static_cast<const float*>(bias), static_cast<T*>(out), R, H, W, p, N, wp, nrm);
  return int(cudaGetLastError());
}

int dispatch_f32(const void* raw, const void* kernel, const void* bias, void* out, int frames,
                 int H, int W, int p, int D, const Norm& nrm, cudaStream_t st) {
  switch (D) {
#define ALPRO_PATCHIFY_CASE(NG) \
  case NG * kTile: return launch<float, NG>(raw, kernel, bias, out, frames, H, W, p, nrm, st);
    ALPRO_PATCHIFY_CASE(2)
    ALPRO_PATCHIFY_CASE(4)
    ALPRO_PATCHIFY_CASE(6)
    ALPRO_PATCHIFY_CASE(8)
#undef ALPRO_PATCHIFY_CASE
    default: return int(cudaErrorInvalidValue);
  }
}

}  // namespace

// raw (frames, H, W, 3) uint8; kernel (p*p*3, D) bf16 or fp32, out (frames,
// N, D) in its dtype. bf16: bias bf16 (vec_bf16 1) or fp32, rows an (frames
// * N, p*p*3) bf16 scratch, p*p*3 % 64 == 0, D % 128 == 0. fp32: bias fp32,
// rows unused, p*p*3 % 128 == 0 up to 1024, D in (256, 512, 768, 1024).
// Either: H and W at least p.
extern "C" int alpro_patchify_embed(const void* raw, const void* kernel, const void* bias,
                                    void* rows, void* out, int frames, int H, int W, int p, int D,
                                    float m0, float m1, float m2, float s0, float s1, float s2,
                                    int is_bf16, int vec_bf16, int device, void* stream) {
  const int K = p * p * 3;
  if (frames < 1 || p < 1 || H < p || W < p || (vec_bf16 && !is_bf16))
    return int(cudaErrorInvalidValue);
  if (is_bf16 ? K % alpro::gemm::kBK || D < alpro::gemm::kBN || D % alpro::gemm::kBN
              : K % kTile || K > 1024)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  const Norm nrm{{m0, m1, m2}, {s0, s1, s2}};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_bf16) return dispatch_f32(raw, kernel, bias, out, frames, H, W, p, D, nrm, st);
  const uint8_t* r = static_cast<const uint8_t*>(raw);
  const bf16* w = static_cast<const bf16*>(kernel);
  bf16* sc = static_cast<bf16*>(rows);
  bf16* o = static_cast<bf16*>(out);
  if (vec_bf16)
    return launch_bf16<bf16>(r, w, static_cast<const bf16*>(bias), sc, o, frames, H, W, p, D, nrm,
                             st);
  return launch_bf16<float>(r, w, static_cast<const float*>(bias), sc, o, frames, H, W, p, D, nrm,
                            st);
}
