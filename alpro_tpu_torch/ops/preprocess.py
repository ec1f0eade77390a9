"""Raw uint8 frames → embedded patch tokens in one kernel call.

Counterpart of ``alpro_tpu/ops/pallas_preprocess.py::fused_patchify_embed``:
kernel ``csrc/patchify_embed.cu``, plain twin ``patchify_embed_plain`` (the
JAX function's math): normalize ``(v/255 − mean)/std`` in fp32, rounded to
the kernel's dtype (``patch_rows_plain``: the (ph, pw, c)-ordered patch
rows); those rows · kernel (p·p·C, D) with fp32 accumulation, + bias in
fp32; output (B, T, N, D) in the kernel's dtype. The normalize is part of
the contract: it is not the fold of ``PatchEmbed`` (which rounds other
values).

In bf16 one call is two launches behind one C call: the patch rows pass
into an (R, p·p·C) bf16 scratch (``patch_rows_plain`` bit for bit), then
the TMA/``wgmma`` GEMM reading the (K, D) kernel in place, its fp32 sums +
bias rounded once. The bias goes in as the model passes it (bf16 beside a
bf16 kernel, widened on load: no cast launch). fp32 is a test dtype: one
row-tile launch on the CUDA cores. The limits of both are ``fits``.

Gradient: as the JAX custom_vjp (``_bwd``), a ``torch.autograd.Function``
whose backward recomputes the fp32 patches and returns dkernel = patchesᵀ·g
and dbias = Σg in the kernel's dtype; the pixels get no gradient. It runs
only where autograd needs it (grad mode on and the kernel or the bias
requiring grad). The forward is the kernel for a CUDA tensor and the twin
for a CPU tensor (the wrapper runs the twin only then; for a CUDA tensor it
launches the kernel or raises). ``launches`` counts wrapper calls that
launched (one per call).
"""

from __future__ import annotations

import torch

from alpro_tpu_torch.ops import _build
from alpro_tpu_torch.ops.ln_mlp import _WIDTHS  # the D values row_tile.cuh's kernels take

launches = 0

_DTYPES = (torch.bfloat16, torch.float32)
_MAX_K = 1024  # fp32: the patch tile (32 x p·p·C) sits in shared memory
# (K multiple, D multiple): bf16 the GEMM's K chunk and column tile
# (csrc/gemm_wgmma.cuh kBK, kBN)
_BF16_STEPS = (64, 128)


def fits(p: int, D: int, H: int, W: int, dtype: torch.dtype) -> bool:
    """Whether the kernel takes patches of p x p x 3 (K = p·p·3 kernel rows)
    into D columns from H x W frames in ``dtype`` (any frame count): bf16 K
    a multiple of 64 (p of 8) and D of 128; fp32 K a multiple of 128 up to
    1024 and D in 256, 512, 768 and 1024; either H and W at least p."""
    K = 3 * p * p
    if p < 1 or H < p or W < p:
        return False
    if dtype == torch.bfloat16:
        return K % _BF16_STEPS[0] == 0 and D > 0 and D % _BF16_STEPS[1] == 0
    if dtype == torch.float32:
        return K <= _MAX_K and K % 128 == 0 and D in _WIDTHS
    return False


def _normalize(raw, mean, std) -> torch.Tensor:
    """(v/255 − mean)/std in fp32 with IEEE divisions on every device (a
    Python-scalar divisor would be a multiply by its reciprocal on CUDA)."""
    m = torch.tensor(mean, dtype=torch.float32, device=raw.device)
    s = torch.tensor(std, dtype=torch.float32, device=raw.device)
    return (raw.float() / torch.tensor(255.0, device=raw.device) - m) / s


def _patches(v: torch.Tensor, p: int) -> torch.Tensor:
    """(B, T, H, W, C) → (B, T, N, p·p·C) in (ph, pw, c) order (the
    reference's strided conv); rows and columns past a whole patch dropped."""
    B, T, H, W, C = v.shape
    hp, wp = H // p, W // p
    v = v[:, :, :hp * p, :wp * p].reshape(B, T, hp, p, wp, p, C).permute(0, 1, 2, 4, 3, 5, 6)
    return v.reshape(B, T, hp * wp, p * p * C)


def _patch_size(raw, kernel) -> int:
    C = raw.shape[-1]
    p = int(round((kernel.shape[0] / C) ** 0.5))
    if p * p * C != kernel.shape[0]:
        raise ValueError(f"kernel rows {kernel.shape[0]} are not p·p·C for C={C}")
    return p


def patch_rows_plain(raw, p: int, mean, std, dtype) -> torch.Tensor:
    """The bf16 route's scratch in plain torch: raw (B, T, H, W, C) uint8 →
    (B·T·N, p·p·C) patch rows in (ph, pw, c) column order, each pixel
    normalized in fp32 and rounded once to ``dtype``."""
    C = raw.shape[-1]
    return _patches(_normalize(raw, mean, std).to(dtype), p).reshape(-1, p * p * C)


def patchify_embed_plain(raw, kernel, bias, mean, std) -> torch.Tensor:
    """Plain twin: the patch rows in the kernel's dtype, the product in fp32
    on those operands, + bias in fp32, out in the kernel's dtype."""
    B, T = raw.shape[:2]
    v = patch_rows_plain(raw, _patch_size(raw, kernel), mean, std, kernel.dtype)
    out = (v.float() @ kernel.float() + bias.float()).to(kernel.dtype)
    return out.reshape(B, T, -1, kernel.shape[1])


class _PatchifyEmbed(torch.autograd.Function):
    """forward: kernel or twin; backward: the JAX ``_bwd`` (fp32 patches)."""

    @staticmethod
    def forward(ctx, raw, kernel, bias, mean, std, fwd):
        ctx.save_for_backward(raw)
        ctx.args = (mean, std, kernel.dtype, _patch_size(raw, kernel))
        return fwd(raw, kernel, bias, mean, std)

    @staticmethod
    def backward(ctx, g):
        (raw,) = ctx.saved_tensors
        mean, std, dtype, p = ctx.args
        patches = _patches(_normalize(raw, mean, std), p)
        gf = g.float()
        dkernel = torch.einsum("btnk,btnd->kd", patches, gf).to(dtype)
        dbias = gf.sum(dim=(0, 1, 2)).to(dtype)
        return None, dkernel, dbias, None, None, None


def patchify_embed(raw: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                   mean, std) -> torch.Tensor:
    """raw (B, T, H, W, C) uint8; kernel (p·p·C, D) with rows in (ph, pw, c)
    order; bias (D,); mean, std: C floats. Returns (B, T, N, D) in the
    kernel's dtype. The kernel takes raw contiguous, C = 3, the kernel
    contiguous in bf16 or fp32 at the widths of ``fits``, the bias bf16
    beside a bf16 kernel (read as it is) or any float dtype (as fp32), and
    raises on anything else."""
    if raw.dim() != 5 or raw.dtype != torch.uint8:
        raise ValueError(f"expected (B, T, H, W, C) uint8, got {raw.dtype} {tuple(raw.shape)}")
    if kernel.dim() != 2 or bias.shape != (kernel.shape[1],):
        raise ValueError(f"kernel {tuple(kernel.shape)}, bias {tuple(bias.shape)}")
    if len(mean) != raw.shape[-1] or len(std) != raw.shape[-1]:
        raise ValueError(f"mean/std need {raw.shape[-1]} values")
    _patch_size(raw, kernel)
    fwd = patchify_embed_plain if raw.device.type == "cpu" else _forward_cuda
    mean, std = tuple(mean), tuple(std)
    if torch.is_grad_enabled() and (kernel.requires_grad or bias.requires_grad):
        return _PatchifyEmbed.apply(raw, kernel, bias, mean, std, fwd)
    return fwd(raw, kernel, bias, mean, std)


def _forward_cuda(raw, kernel, bias, mean, std) -> torch.Tensor:
    """The checks of a CUDA call, then the launch: past a limit it raises
    before any launch."""
    _build.check_cuda_operand(raw, "patchify_embed raw", (torch.uint8,), align=1)
    _build.check_cuda_operand(kernel, "patchify_embed kernel", _DTYPES)
    B, T, H, W, C = raw.shape
    p = _patch_size(raw, kernel)
    K, D = kernel.shape
    if C != 3 or B * T < 1 or not fits(p, D, H, W, kernel.dtype):
        raise ValueError(
            f"patchify_embed kernel needs C == 3, frames at least p on each side and, for "
            f"{kernel.dtype}, " + ("p·p·C % 64 == 0 and D % 128 == 0"
                                   if kernel.dtype == torch.bfloat16 else
                                   f"p·p·C % 128 == 0 up to {_MAX_K} and D in {_WIDTHS}")
            + f"; got C={C}, p·p·C={K}, D={D}, frames {B * T} of {H}x{W}"
        )
    (b,), vec_bf16 = _build.layer_vectors("patchify_embed", kernel, dict(bias=bias))
    return _launch(raw, kernel, b, vec_bf16, mean, std)


def _launch(raw, kernel, bias, vec_bf16: int, mean, std, rows=None) -> torch.Tensor:
    """One launch of the checked operands; bias as ``_build.layer_vectors``
    gives it. bf16: ``rows``, where given, is the (B·T·N, p·p·C) bf16 scratch
    of the patch rows (else a new one)."""
    global launches
    B, T, H, W, _ = raw.shape
    p = _patch_size(raw, kernel)
    K, D = kernel.shape
    N = (H // p) * (W // p)
    bf16 = kernel.dtype == torch.bfloat16
    out = torch.empty((B, T, N, D), dtype=kernel.dtype, device=raw.device)
    if bf16 and rows is None:
        rows = torch.empty((B * T * N, K), dtype=kernel.dtype, device=raw.device)
    dev, stream = _build.stream_args(raw)
    err = _build.lib().alpro_patchify_embed(
        raw.data_ptr(), kernel.data_ptr(), bias.data_ptr(),
        rows.data_ptr() if bf16 else None, out.data_ptr(), B * T, H, W, p, D,
        *map(float, mean), *map(float, std), int(bf16), vec_bf16, dev, stream,
    )
    _build.check(err, "patchify_embed")
    launches += 1
    return out
