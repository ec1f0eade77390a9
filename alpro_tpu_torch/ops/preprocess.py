"""Raw uint8 frames → embedded patch tokens in one kernel.

Counterpart of ``alpro_tpu/ops/pallas_preprocess.py::fused_patchify_embed``:
kernel ``csrc/patchify_embed.cu``, plain twin ``patchify_embed_plain`` (the
JAX function's math): normalize ``(v/255 − mean)/std`` in fp32, rounded to
the kernel's dtype; the (ph, pw, c)-ordered patch vectors · kernel
(p·p·C, D) with fp32 accumulation, + bias in fp32; output (B, T, N, D) in
the kernel's dtype. The normalize is part of the contract: it is not the
fold of ``PatchEmbed`` (which rounds other values).

Gradient: as the JAX custom_vjp (``_bwd``), a ``torch.autograd.Function``
whose backward recomputes the fp32 patches and returns dkernel = patchesᵀ·g
and dbias = Σg in the kernel's dtype; the pixels get no gradient. Its
forward is the kernel for a CUDA tensor and the twin for a CPU tensor (the
wrapper runs the twin only then; for a CUDA tensor it launches the kernel or
raises). ``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from alpro_tpu_torch.ops import _build
from alpro_tpu_torch.ops.ln_mlp import _WIDTHS  # the D values row_tile.cuh's kernels take

launches = 0

_DTYPES = (torch.bfloat16, torch.float32)
_MAX_K = 1024  # csrc/patchify_embed.cu: the patch tile (32 x p·p·C) sits in shared memory


def _normalize(raw, mean, std) -> torch.Tensor:
    m = torch.tensor(mean, dtype=torch.float32, device=raw.device)
    s = torch.tensor(std, dtype=torch.float32, device=raw.device)
    return (raw.float() / 255.0 - m) / s


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


def patchify_embed_plain(raw, kernel, bias, mean, std) -> torch.Tensor:
    """Plain twin: the normalized pixels rounded to the kernel's dtype, the
    product in fp32 on those operands, + bias in fp32, out in the kernel's
    dtype."""
    v = _patches(_normalize(raw, mean, std).to(kernel.dtype), _patch_size(raw, kernel))
    return (v.float() @ kernel.float() + bias.float()).to(kernel.dtype)


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
    kernel's dtype. The kernel takes raw contiguous, C = 3, p·p·C % 128 == 0
    up to 1024, D in (256, 512, 768, 1024) and the kernel's dtype bf16 or
    fp32, and raises on anything else."""
    if raw.dim() != 5 or raw.dtype != torch.uint8:
        raise ValueError(f"expected (B, T, H, W, C) uint8, got {raw.dtype} {tuple(raw.shape)}")
    if kernel.dim() != 2 or bias.shape != (kernel.shape[1],):
        raise ValueError(f"kernel {tuple(kernel.shape)}, bias {tuple(bias.shape)}")
    if len(mean) != raw.shape[-1] or len(std) != raw.shape[-1]:
        raise ValueError(f"mean/std need {raw.shape[-1]} values")
    _patch_size(raw, kernel)
    fwd = patchify_embed_plain if raw.device.type == "cpu" else _launch
    return _PatchifyEmbed.apply(raw, kernel, bias, tuple(mean), tuple(std), fwd)


def _launch(raw, kernel, bias, mean, std) -> torch.Tensor:
    global launches
    _build.check_cuda_operand(raw, "patchify_embed raw", (torch.uint8,), align=1)
    _build.check_cuda_operand(kernel, "patchify_embed kernel", _DTYPES)
    B, T, H, W, C = raw.shape
    p = _patch_size(raw, kernel)
    K, D = kernel.shape
    hp, wp = H // p, W // p
    if C != 3 or K % 128 or K > _MAX_K or D not in _WIDTHS or hp * wp < 1:
        raise ValueError(
            f"patchify_embed kernel needs C == 3, p·p·C % 128 == 0 up to {_MAX_K} and D in "
            f"{_WIDTHS}; got C={C}, p·p·C={K}, D={D}, frames {H}x{W}"
        )
    b = bias.float().contiguous()
    _build.check_cuda_operand(b, "patchify_embed bias", (torch.float32,), align=4)
    out = torch.empty((B, T, hp * wp, D), dtype=kernel.dtype, device=raw.device)
    dev, stream = _build.stream_args(raw)
    err = _build.lib().alpro_patchify_embed(
        raw.data_ptr(), kernel.data_ptr(), b.data_ptr(), out.data_ptr(), B * T, H, W, p, D,
        *map(float, mean), *map(float, std), int(kernel.dtype == torch.bfloat16), dev, stream,
    )
    _build.check(err, "patchify_embed")
    launches += 1
    return out
