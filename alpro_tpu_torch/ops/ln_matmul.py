"""LayerNorm → matmul: the pre-attention LN riding the qkv projection.

Counterpart of ``alpro_tpu/ops/pallas_ln_mlp.py::fused_ln_matmul``: kernel
``csrc/ln_matmul.cu``, plain twin ``ln_matmul_plain`` (=
``_ln_matmul_xla_reference``, which is also the TPU kernel's contract: the
LN output rounded to the weight's dtype, fp32 products and bias, one
rounding). The weight is in torch Linear layout (F, D), the transpose of the
JAX function's (D, F), so the model's ``nn.Linear`` weight goes in without a
copy. The output is in x's dtype (the JAX function's default ``out_dtype``).

In bf16 one call is two launches behind one C call: the LN rows into an
(R, D) bf16 scratch, then the TMA/``wgmma`` GEMM with its fp32 accumulator,
+ b, rounded once (``csrc/ln_rows.cuh``'s ``launch_ln_linear``, which B10's
bf16 route shares). It takes the layer's bf16 LN and bias vectors as they
are (``_build.layer_vectors``: no cast launch). fp32 is a test dtype: one
row-tile launch on the CUDA cores.

The wrapper runs the twin only for a CPU tensor; for a CUDA tensor it
launches the kernel or raises. ``launches`` counts wrapper calls that
launched (one per call). The kernel has no backward (the JAX model reaches
it only at serving): the wrapper raises when grad mode is on and an input
requires grad.
"""

from __future__ import annotations

import torch

from alpro_tpu_torch.ops import _build
from alpro_tpu_torch.ops.kernel_math import ln_rows_f32

launches = 0

_DTYPES = (torch.bfloat16, torch.float32)
_MAX_D = 1024  # csrc/ln_rows.cuh: a row in one warp's registers; fp32's row tile in shared memory
# (D multiple, F multiple): bf16 the GEMM's K chunk and column tile
# (csrc/gemm_wgmma.cuh kBK, kBN); fp32 the row tile and its pass of 768 columns
_STEPS = {torch.bfloat16: (64, 128), torch.float32: (128, 768)}


def ln_matmul_plain(x, scale, bias, w, b, eps: float) -> torch.Tensor:
    """Plain twin: one-pass fp32 LN, rounded to the weight's dtype; the
    product on those operands accumulated in fp32 (the upcast products of
    bf16 values are exact in fp32), + b in fp32; output in x.dtype."""
    xn = ln_rows_f32(x, scale, bias, eps)
    y = xn.to(w.dtype).float() @ w.float().t() + b.float()
    return y.to(x.dtype)


def fits(D: int, F: int, dtype: torch.dtype) -> bool:
    """Whether the kernel takes rows of D into F outputs in ``dtype`` (any
    row count R >= 1): bf16 D a multiple of 64 up to 1024 and F of 128;
    fp32 D a multiple of 128 up to 1024 and F of 768."""
    if dtype not in _STEPS:
        return False
    d_step, f_step = _STEPS[dtype]
    return 0 < D <= _MAX_D and D % d_step == 0 and F > 0 and F % f_step == 0


def ln_matmul(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              w: torch.Tensor, b: torch.Tensor, *, eps: float) -> torch.Tensor:
    """``LN(x)·Wᵀ + b`` over the rows of x (..., D) → (..., F). w: (F, D);
    scale, bias: (D,); b: (F,), any float dtype. The kernel takes x and w
    contiguous in one dtype (bf16 or fp32) at the widths of ``fits``, the
    vectors all bf16 beside bf16 x (read as they are) or any float dtype
    (as fp32), and raises on anything else."""
    D = x.shape[-1]
    F = w.shape[0]
    if (tuple(w.shape) != (F, D) or scale.shape != (D,) or bias.shape != (D,)
            or b.shape != (F,)):
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, w {tuple(w.shape)}, b {tuple(b.shape)}, "
            f"scale {tuple(scale.shape)}, bias {tuple(bias.shape)}"
        )
    _build.refuse_grad("ln_matmul", x, scale, bias, w, b)
    if x.device.type == "cpu":
        return ln_matmul_plain(x, scale, bias, w, b, eps)
    _build.check_cuda_operand(x, "ln_matmul x", _DTYPES)
    _build.check_cuda_operand(w, "ln_matmul w", (x.dtype,))
    if x.numel() == 0 or not fits(D, F, x.dtype):
        d_step, f_step = _STEPS[x.dtype]
        raise ValueError(
            f"ln_matmul kernel needs, for {x.dtype}, D % {d_step} == 0, D <= {_MAX_D}, "
            f"F % {f_step} == 0 and at least one row; got R={x.numel() // max(D, 1)}, D={D}, "
            f"F={F}"
        )
    vecs, vec_bf16 = _build.layer_vectors("ln_matmul", x, dict(scale=scale, bias=bias, b=b))
    return _launch(x, vecs, vec_bf16, w, eps)


def _launch(x, vecs, vec_bf16: int, w, eps: float) -> torch.Tensor:
    """One launch of the checked operands; vecs (scale, bias, b) as
    ``_build.layer_vectors`` gives them."""
    global launches
    D, F = x.shape[-1], w.shape[0]
    R = x.numel() // D
    bf16 = x.dtype == torch.bfloat16
    out = torch.empty(x.shape[:-1] + (F,), dtype=x.dtype, device=x.device)
    xn = torch.empty((R, D), dtype=x.dtype, device=x.device) if bf16 else None
    dev, stream = _build.stream_args(x)
    err = _build.lib().alpro_ln_matmul(
        x.data_ptr(), vecs[0].data_ptr(), vecs[1].data_ptr(), w.data_ptr(), vecs[2].data_ptr(),
        None if xn is None else xn.data_ptr(), out.data_ptr(), R, D, F, float(eps), int(bf16),
        vec_bf16, dev, stream,
    )
    _build.check(err, "ln_matmul")
    launches += 1
    return out
