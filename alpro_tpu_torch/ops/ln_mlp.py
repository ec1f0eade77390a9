"""Fused LayerNorm → MLP → residual of the TimeSformer block tail.

Counterpart of ``alpro_tpu/ops/pallas_ln_mlp.py::fused_ln_mlp``: kernel
``csrc/ln_mlp.cu``, plain twin ``ln_mlp_plain`` (= ``_ln_mlp_xla_reference``).
The weights are in torch Linear layout — ``w1`` (Dh, D), ``w2`` (D, Dh) —
the transposes of the JAX kernels' (D, Dh) and (Dh, D), so the model's
``nn.Linear`` weights go in without a copy.

The wrapper runs the twin only for a CPU tensor; for a CUDA tensor it
launches the kernel or raises. ``launches`` counts kernel launches. The
kernel has no backward (the JAX model runs it only at serving): the wrapper
raises when grad mode is on and an input requires grad.
"""

from __future__ import annotations

import torch

from alpro_tpu_torch.ops import _build
from alpro_tpu_torch.ops.kernel_math import gelu_exact_f32, ln_rows_f32

launches = 0

_DTYPES = (torch.bfloat16, torch.float32)
_HIDDEN_CHUNK = 128  # csrc/ln_mlp.cu kTile
_ROW_TILE = 32  # csrc/ln_mlp.cu kTM
_WIDTHS = (256, 512, 768, 1024)  # D values csrc/ln_mlp.cu is instantiated for


def ln_mlp_fits(D: int, Dh: int, dtype: torch.dtype) -> bool:
    """Whether the row-tile MLP kernels (K3 here, K5 in ``ops/bert_block.py``)
    take width D and hidden width Dh in ``dtype``; their shared memory is
    fixed by D and lies well inside an H100's for every D they take."""
    return dtype in _DTYPES and D in _WIDTHS and Dh >= _HIDDEN_CHUNK and Dh % _HIDDEN_CHUNK == 0


def hidden_split(R: int, Dh: int, num_sms: int) -> int:
    """Hidden columns per block: all of Dh when the row tiles fill the SMs,
    else Dh cut into equal whole chunks over ~num_sms // row_tiles blocks
    (their fp32 partials are summed by a second pass)."""
    chunks = Dh // _HIDDEN_CHUNK
    row_tiles = -(-R // _ROW_TILE)
    splits = min(chunks, max(1, -(-num_sms // row_tiles)))
    return -(-chunks // splits) * _HIDDEN_CHUNK


def ln_mlp_plain(x, scale, bias, w1, b1, w2, b2, eps: float,
                 residual: bool = True) -> torch.Tensor:
    """Plain twin: LN in fp32; fc1/fc2 on operands rounded to the weights'
    dtype, accumulated in fp32 (the upcast products of bf16 values are exact
    in fp32); exact GELU in fp32; residual in fp32; output in x.dtype."""
    xf = x.float()
    xn = ln_rows_f32(xf, scale, bias, eps)
    h = xn.to(w1.dtype).float() @ w1.float().t() + b1.float()
    g = gelu_exact_f32(h)
    y = g.to(w2.dtype).float() @ w2.float().t() + b2.float()
    if residual:
        y = y + xf
    return y.to(x.dtype)


def ln_mlp(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
           w1: torch.Tensor, b1: torch.Tensor, w2: torch.Tensor, b2: torch.Tensor,
           *, eps: float, residual: bool = True) -> torch.Tensor:
    """``[x +] fc2(gelu_exact(fc1(LN(x))))`` over rows of x (R, D), the
    (R, Dh) hidden never written out. w1: (Dh, D), w2: (D, Dh); scale, bias,
    b1, b2 any float dtype. The kernel takes x, w1, w2 contiguous in one
    dtype (bf16 or fp32), D in (256, 512, 768, 1024) and Dh % 128 == 0, and
    raises on anything else."""
    global launches
    if x.dim() != 2:
        raise ValueError(f"expected (R, D) rows, got shape {tuple(x.shape)}")
    R, D = x.shape
    Dh = w1.shape[0]
    if (tuple(w1.shape) != (Dh, D) or tuple(w2.shape) != (D, Dh)
            or scale.shape != (D,) or bias.shape != (D,)
            or b1.shape != (Dh,) or b2.shape != (D,)):
        raise ValueError(
            f"shape mismatch: x {tuple(x.shape)}, w1 {tuple(w1.shape)}, "
            f"w2 {tuple(w2.shape)}, b1 {tuple(b1.shape)}, b2 {tuple(b2.shape)}"
        )
    _build.refuse_grad("ln_mlp", x, scale, bias, w1, b1, w2, b2)
    if x.device.type == "cpu":
        return ln_mlp_plain(x, scale, bias, w1, b1, w2, b2, eps, residual)
    _build.check_cuda_operand(x, "ln_mlp x", _DTYPES)
    for name, w in (("w1", w1), ("w2", w2)):
        _build.check_cuda_operand(w, f"ln_mlp {name}", (x.dtype,))
    if not ln_mlp_fits(D, Dh, x.dtype) or R < 1:
        raise ValueError(
            f"ln_mlp kernel needs D in {_WIDTHS} and Dh % {_HIDDEN_CHUNK} == 0;"
            f" got R={R}, D={D}, Dh={Dh}"
        )
    vecs = [v.float().contiguous() for v in (scale, bias, b1, b2)]
    for name, v in zip(("scale", "bias", "b1", "b2"), vecs):
        _build.check_cuda_operand(v, f"ln_mlp {name}", (torch.float32,), align=4)
    out = torch.empty_like(x)
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    h_split = hidden_split(R, Dh, sms)
    partial = None
    if h_split < Dh:
        partial = torch.empty((-(-Dh // h_split), R, D), dtype=torch.float32, device=x.device)
    dev, stream = _build.stream_args(x)
    err = _build.lib().alpro_ln_mlp(
        x.data_ptr(), vecs[0].data_ptr(), vecs[1].data_ptr(), w1.data_ptr(),
        vecs[2].data_ptr(), w2.data_ptr(), vecs[3].data_ptr(), out.data_ptr(),
        None if partial is None else partial.data_ptr(), R, D, Dh, h_split,
        float(eps), int(residual), int(x.dtype == torch.bfloat16), dev, stream,
    )
    _build.check(err, "ln_mlp")
    launches += 1
    return out
