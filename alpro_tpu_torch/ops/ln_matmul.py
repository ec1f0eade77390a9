"""LayerNorm → matmul: the pre-attention LN riding the qkv projection.

Counterpart of ``alpro_tpu/ops/pallas_ln_mlp.py::fused_ln_matmul``: kernel
``csrc/ln_matmul.cu``, plain twin ``ln_matmul_plain`` (=
``_ln_matmul_xla_reference``). The weight is in torch Linear layout (F, D),
the transpose of the JAX function's (D, F), so the model's ``nn.Linear``
weight goes in without a copy. The output is in x's dtype (the JAX
function's default ``out_dtype``).

The wrapper runs the twin only for a CPU tensor; for a CUDA tensor it
launches the kernel or raises. ``launches`` counts kernel launches. The
kernel has no backward (the JAX model reaches it only at serving): the
wrapper raises when grad mode is on and an input requires grad.
"""

from __future__ import annotations

import torch

from alpro_tpu_torch.ops import _build
from alpro_tpu_torch.ops.kernel_math import ln_rows_f32

launches = 0

_DTYPES = (torch.bfloat16, torch.float32)
_COL_CHUNK = 768  # csrc/ln_matmul.cu: output columns per pass (6 groups of 128)
_MAX_D = 1024  # csrc/ln_matmul.cu: the LN'd row tile (32 x D) sits in shared memory


def ln_matmul_plain(x, scale, bias, w, b, eps: float) -> torch.Tensor:
    """Plain twin: one-pass fp32 LN, rounded to the weight's dtype; the
    product on those operands accumulated in fp32 (the upcast products of
    bf16 values are exact in fp32), + b in fp32; output in x.dtype."""
    xn = ln_rows_f32(x, scale, bias, eps)
    y = xn.to(w.dtype).float() @ w.float().t() + b.float()
    return y.to(x.dtype)


def ln_matmul(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              w: torch.Tensor, b: torch.Tensor, *, eps: float) -> torch.Tensor:
    """``LN(x)·Wᵀ + b`` over the rows of x (..., D) → (..., F). w: (F, D);
    scale, bias: (D,); b: (F,), any float dtype. The kernel takes x and w
    contiguous in one dtype (bf16 or fp32), D % 128 == 0 up to 1024 and
    F % 768 == 0, and raises on anything else."""
    global launches
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
    R = x.numel() // D
    if D % 128 or D > _MAX_D or F % _COL_CHUNK or R < 1:
        raise ValueError(
            f"ln_matmul kernel needs D % 128 == 0, D <= {_MAX_D} and F % {_COL_CHUNK} == 0;"
            f" got R={R}, D={D}, F={F}"
        )
    vecs = [v.float().contiguous() for v in (scale, bias, b)]
    for name, v in zip(("scale", "bias", "b"), vecs):
        _build.check_cuda_operand(v, f"ln_matmul {name}", (torch.float32,), align=4)
    out = torch.empty(x.shape[:-1] + (F,), dtype=x.dtype, device=x.device)
    dev, stream = _build.stream_args(x)
    err = _build.lib().alpro_ln_matmul(
        x.data_ptr(), vecs[0].data_ptr(), vecs[1].data_ptr(), w.data_ptr(),
        vecs[2].data_ptr(), out.data_ptr(), R, D, F, float(eps),
        int(x.dtype == torch.bfloat16), dev, stream,
    )
    _build.check(err, "ln_matmul")
    launches += 1
    return out
