"""Fused LayerNorm → MLP → residual of the TimeSformer block tail.

Counterpart of ``alpro_tpu/ops/pallas_ln_mlp.py::fused_ln_mlp``: kernel
``csrc/ln_mlp.cu``, plain twin ``ln_mlp_plain`` (= ``_ln_mlp_xla_reference``).
The weights are in torch Linear layout — ``w1`` (Dh, D), ``w2`` (D, Dh) —
the transposes of the JAX kernels' (D, Dh) and (Dh, D), so the model's
``nn.Linear`` weights go in without a copy.

In bf16 one wrapper call is up to four launches behind one C call (the
source gives the design): the LN rows, fc1 + GELU and fc2 on the TMA/
``wgmma`` GEMM (``csrc/gemm_wgmma.cuh``), and where fc2's hidden is cut into
slices, the pass that sums their fp32 partials. ``bf16_plan`` is that
launch plan (the slices and the scratch) from R, D, Dh and the SM count;
K5 (``ops/bert_block.py``) takes the same plan. fp32 keeps a CUDA-core row
kernel, its hidden split by ``hidden_split``.

The wrapper runs the twin only for a CPU tensor; for a CUDA tensor it
launches the kernel or raises. ``launches`` counts wrapper calls that
launched (one per call). The kernel has no backward (the JAX model runs it
only at serving): the wrapper raises when grad mode is on and an input
requires grad.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from alpro_tpu_torch.ops import _build
from alpro_tpu_torch.ops.kernel_math import gelu_exact_f32, ln_rows_f32

launches = 0

_DTYPES = (torch.bfloat16, torch.float32)
_HIDDEN_CHUNK = 128  # csrc/ln_mlp.cu kTile
_ROW_TILE = 32  # csrc/ln_mlp.cu kTM
_WIDTHS = (256, 512, 768, 1024)  # D values csrc/ln_mlp.cu is instantiated for
# fp32's row kernel holds a 32 x D tile, an fp32 hidden chunk, a GELU chunk
# and a 128 x 128 weight tile in shared memory: 232,960 bytes at D = 1024,
# past the 232,448 a Hopper block may take, so fp32 stops at 768
_F32_WIDTHS = (256, 512, 768)
_GEMM_TILE = 128  # csrc/gemm_wgmma.cuh kBM = kBN: 128 x 128 output tiles
_GEMM_K = 64  # csrc/gemm_wgmma.cuh kBK: fc2's K slices are multiples
_GEMM_PER_SM = 2  # csrc/gemm_wgmma.cuh kMinBlocks: CTAs an SM holds at once


@dataclasses.dataclass(frozen=True)
class Bf16Plan:
    """The bf16 launch plan of one K3 or K5 call: fc2's hidden cut into
    ``splits`` slices of ``h_split`` columns, and the scratch shapes (None:
    not allocated) — ``hidden`` bf16 gelu(fc1), ``normed`` bf16 LN(x) (K3
    only), ``partial`` the fp32 sums of fc2's slices (absent only for K3
    in one slice, whose fc2 rounds straight into the output)."""

    h_split: int
    splits: int
    hidden: tuple
    normed: Optional[tuple]
    partial: Optional[tuple]


def bf16_plan(R: int, D: int, Dh: int, num_sms: int, post_ln: bool) -> Bf16Plan:
    """fc2 has ceil(R / 128) · D / 128 output tiles; where they leave CTA
    slots of the card free (``_GEMM_PER_SM`` per SM), its hidden is cut into
    as many equal 64-column slices as one wave of slots takes."""
    tiles = -(-R // _GEMM_TILE) * (D // _GEMM_TILE)
    chunks = Dh // _GEMM_K
    want = min(chunks, max(1, _GEMM_PER_SM * num_sms // tiles))
    h_split = -(-chunks // want) * _GEMM_K
    splits = -(-Dh // h_split)
    partial = None if splits == 1 and not post_ln else (splits, R, D)
    return Bf16Plan(h_split, splits, (R, Dh), None if post_ln else (R, D), partial)


def launch_scratch(x: torch.Tensor, R: int, D: int, Dh: int, post_ln: bool) -> tuple:
    """(h_split, partial, hidden, normed) of one kernel call on CUDA ``x``:
    the bf16 plan's scratch, or fp32's ``hidden_split`` and its partials."""
    def empty(shape, dtype):
        return None if shape is None else torch.empty(shape, dtype=dtype, device=x.device)

    sms = _build.sm_count(x.device)
    if x.dtype == torch.bfloat16:
        plan = bf16_plan(R, D, Dh, sms, post_ln)
        return (plan.h_split, empty(plan.partial, torch.float32), empty(plan.hidden, x.dtype),
                empty(plan.normed, x.dtype))
    h_split = hidden_split(R, Dh, sms)
    partial = (-(-Dh // h_split), R, D) if h_split < Dh else None
    return h_split, empty(partial, torch.float32), None, None


def ptr(t: Optional[torch.Tensor]):
    """A tensor's data pointer for ctypes, None for no tensor."""
    return None if t is None else t.data_ptr()


def ln_mlp_fits(D: int, Dh: int, dtype: torch.dtype) -> bool:
    """Whether the MLP kernels (K3 here, K5 in ``ops/bert_block.py``) take
    width D and hidden width Dh in ``dtype``: D in ``_WIDTHS`` (fp32:
    ``_F32_WIDTHS``) and Dh a multiple of 128."""
    widths = _F32_WIDTHS if dtype == torch.float32 else _WIDTHS
    return dtype in _DTYPES and D in widths and Dh >= _HIDDEN_CHUNK and Dh % _HIDDEN_CHUNK == 0


def hidden_split(R: int, Dh: int, num_sms: int) -> int:
    """fp32: hidden columns per block: all of Dh when the row tiles fill the
    SMs, else Dh cut into equal whole chunks over ~num_sms // row_tiles
    blocks (their fp32 partials are summed by a second pass)."""
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
    """``[x +] fc2(gelu_exact(fc1(LN(x))))`` over rows of x (R, D). w1:
    (Dh, D), w2: (D, Dh); scale, bias, b1, b2 any float dtype. The kernel
    takes x, w1, w2 contiguous in one dtype (bf16 or fp32), D in (256, 512,
    768, 1024) (fp32: up to 768) and Dh % 128 == 0, and raises on anything
    else."""
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
            f"ln_mlp kernel needs D in {_WIDTHS} ({_F32_WIDTHS} in fp32) and Dh % "
            f"{_HIDDEN_CHUNK} == 0; got R={R}, D={D}, Dh={Dh}, {x.dtype}"
        )
    vecs = [v.float().contiguous() for v in (scale, bias, b1, b2)]
    for name, v in zip(("scale", "bias", "b1", "b2"), vecs):
        _build.check_cuda_operand(v, f"ln_mlp {name}", (torch.float32,), align=4)
    out = torch.empty_like(x)
    h_split, partial, hidden, normed = launch_scratch(x, R, D, Dh, post_ln=False)
    dev, stream = _build.stream_args(x)
    err = _build.lib().alpro_ln_mlp(
        x.data_ptr(), vecs[0].data_ptr(), vecs[1].data_ptr(), w1.data_ptr(),
        vecs[2].data_ptr(), w2.data_ptr(), vecs[3].data_ptr(), out.data_ptr(), ptr(partial),
        ptr(hidden), ptr(normed), R, D, Dh, h_split, float(eps), int(residual),
        int(x.dtype == torch.bfloat16), dev, stream,
    )
    _build.check(err, "ln_mlp")
    launches += 1
    return out
