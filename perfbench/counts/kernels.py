"""Operations and bytes of the port's hand-written kernels, from their shapes
(copied from ``chip_smoke.py``'s roofline arithmetic, its ``work=``
arguments), and the least time the card could take for them.

Each function returns (FLOPs, bytes): every input byte read once and every
output byte written once, bf16 activations and weights, fp32 LayerNorm
vectors, mask and biases where the kernel reads them so."""

from __future__ import annotations

from typing import Tuple

from perfbench.lib.device import PEAK_BF16_FLOPS, PEAK_HBM_BYTES

Work = Tuple[float, float]

# base names of the port's kernels as the device trace names them
# (``alpro_tpu_torch/csrc``'s ``__global__`` functions)
PORT_KERNELS = frozenset({
    "attn_wgmma", "bert_attn_heads", "bert_attn_proj_ln", "bert_mlp_finalize",
    "block_attn_heads", "gemm_wgmma", "gemm_wgmma_kn", "layernorm_kernel", "ln_matmul_kernel",
    "ln_mlp_kernel", "ln_mlp_finalize", "ln_rows", "masked_attn_f32", "patch_rows",
    "patchify_embed_kernel", "proj_rows", "spatial_attn_f32", "spatial_block_heads",
    "spatial_proj_heads", "temporal_attn_tma", "temporal_attn_wide", "temporal_block_heads",
    "temporal_proj",
})


def bound_s(work: Work) -> float:
    """max(FLOPs / peak bf16 rate, bytes / peak HBM bandwidth)."""
    flops, nbytes = work
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def spatial_attn(M: int, S: int, H: int = 12, hd: int = 64) -> Work:
    """K1: attention over S tokens of M sequences from the packed (M, S, 3D)
    qkv into (M, S, D)."""
    return 4 * M * H * S * S * hd, 2 * (M * S * 3 * H * hd) * 4 // 3


def temporal_attn(B: int, T: int, N: int, H: int = 12, hd: int = 64) -> Work:
    """K2: attention over T frames at each of B·N locations, packed qkv in."""
    return 4 * B * N * H * T * T * hd, 2 * (B * T * N * 3 * H * hd) * 4 // 3


def ln_mlp(R: int, D: int = 768, Dh: int = 3072) -> Work:
    """K3 (pre-LN) and K5 (post-LN): LN, fc1, GELU, fc2 and the residual
    over R rows."""
    w_bytes = 2 * D * Dh * 2 + (Dh + 3 * D) * 4
    return 4 * R * D * Dh, 2 * R * D * 2 + w_bytes


def bert_attn(M: int, S: int, D: int = 768, H: int = 12) -> Work:
    """K4: q, k, v, the masked attention, the projection, residual and LN
    over M sequences of S tokens."""
    hd = D // H
    return (8 * M * S * D * D + 4 * M * H * S * S * hd,
            2 * M * S * D * 2 + 4 * D * D * 2 + M * S * 4 + 6 * D * 2)


def ingest_call(B: int, T: int, N: int = 196, depth: int = 12) -> Work:
    """The port's kernels in one ``add_videos`` call of B clips under
    ``auto`` in eval: per block K2, K1 and K3 on the patch rows and on the
    B CLS rows."""
    parts = [temporal_attn(B, T, N), spatial_attn(B * T, 1 + N), ln_mlp(B * T * N), ln_mlp(B)]
    return depth * sum(p[0] for p in parts), depth * sum(p[1] for p in parts)


def ingest_call_bound_s(B: int, T: int, N: int = 196, depth: int = 12) -> float:
    """The least time of one call's kernels, summed kernel by kernel."""
    parts = [temporal_attn(B, T, N), spatial_attn(B * T, 1 + N), ln_mlp(B * T * N), ln_mlp(B)]
    return depth * sum(bound_s(p) for p in parts)


def query_bound_s(text_len: int, topk: int, video_tokens: int = 197, layers: int = 6) -> float:
    """The least time of the port's kernels in one ``query``: K4 and K5 in
    each layer of the text half (one text) and of the fusion half (topk
    pairs of text_len + video_tokens)."""
    S = text_len + video_tokens
    return layers * (bound_s(bert_attn(1, text_len)) + bound_s(ln_mlp(text_len))
                     + bound_s(bert_attn(topk, S)) + bound_s(ln_mlp(topk * S)))
