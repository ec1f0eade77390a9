// K2's and B16's entry: the attention over T of csrc/temporal_attn.cuh (its
// header says what it replaces, what bounds it and its design).
#include "temporal_attn.cuh"

// qkv (B, T, N, 3 H hd) -> out (B, T, N, H hd); hd % 8 == 0, hd <= 128,
// 1 <= T <= 128, B·T·N < 2^31.
extern "C" int alpro_temporal_attn(const void* qkv, void* out, int B, int Tn, int N, int H,
                                   int hd, float scale, int is_bf16, int device,
                                   void* stream) {
  namespace ta = alpro::tattn;
  if (B < 1 || N < 1 || H < 1 || Tn < 1 || Tn > ta::kMaxT || hd < 8 || hd > 128 || hd % 8 ||
      long(B) * Tn * N > 0x7fffffffL)
    return int(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return int(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? ta::dispatch<__nv_bfloat16>(qkv, out, B, Tn, N, H, hd, scale, device, s)
                 : ta::dispatch<float>(qkv, out, B, Tn, N, H, hd, scale, device, s);
}

// The dynamic shared memory of K2's launch at T frames and head_dim hd on
// this device (the fast path's two stages, or the wide path's warps), 0 where
// none fits or the shape is outside the limits above.
extern "C" int alpro_temporal_attn_smem(int Tn, int hd, int is_bf16, int device) {
  namespace ta = alpro::tattn;
  if (Tn < 1 || Tn > ta::kMaxT || hd < 8 || hd > 128 || hd % 8) return 0;
  return int(is_bf16 ? ta::launch_smem<__nv_bfloat16>(Tn, hd, device)
                     : ta::launch_smem<float>(Tn, hd, device));
}
