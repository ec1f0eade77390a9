"""B17's and B14's host-side code (``alpro_tpu_torch.ops.block_attn`` and
``ops.layernorm``), on the CPU.

The bf16 B17 launch's plan: ``fits`` and ``max_seq`` (the attention body's
plan under kSplit, with the key-bias row), the kSplit layout's bytes (a
query buffer holds q_hi and q_lo, a K slot k_hi, v and k_lo), the scratch
one call allocates, and the GEMM wrapper's shape checks. Then the routing of
a call on a CUDA tensor: with ``_launch`` and the autograd Function replaced
by recorders and a CUDA stand-in for the tensors, a call that needs no
gradient launches directly and a call that needs one goes through the
Function (whose backward is the gradient). The shared memory is an H100's:
232,448 bytes a block may opt in to. ``csrc/block_attn.cu`` reports the
same ``max_seq`` on the card (tests/test_torch_cuda_kernels.py).
"""

import pytest
import torch

from alpro_tpu_torch.ops import _build, block_attn, layernorm, qkv_attn

H100_SMEM = 232_448
BF16, F32 = torch.bfloat16, torch.float32


def test_ksplit_plan_bytes():
    """kSplit's layout: one query buffer of q_hi and q_lo (K1's two query
    tiles' bytes), a K slot of k_hi, v and k_lo, one chunk's keys rounded to
    16 rows with a pad of the rest of the last 64-key block after the slots.
    At S = 197 (208 rows, 48 rows of pad) 105,472 bytes, 106,496 with the
    key-bias row: two CTAs fit an SM (K1's 84,992 at 256 rows)."""
    assert qkv_attn.attn_wgmma_smem(197, 64, H100_SMEM) == 84992
    fixed = 2048 + 2 * 64 * 64 * 2 + 1024
    assert block_attn.attention_smem(197, H100_SMEM, False) == fixed + 48 * 128 + 3 * 208 * 128
    assert block_attn.attention_smem(197, H100_SMEM, False) == 105472
    assert block_attn.attention_smem(197, H100_SMEM, True) == 106496
    assert 2 * (106496 + 1024) <= 228 * 1024  # two CTAs and their reserved 1 KB each
    assert block_attn.attention_smem(192, H100_SMEM, True) == fixed + 1024 + 3 * 192 * 128
    assert block_attn.attention_smem(256, H100_SMEM, False) == fixed + 3 * 256 * 128
    # past one chunk: a ring of two 96 KB slots of 256 keys and a bias row
    # of 1 KB a chunk, up to 16 chunks
    assert block_attn.attention_smem(257, H100_SMEM, False) == fixed + 2 * 3 * 256 * 128
    assert block_attn.attention_smem(257, H100_SMEM, True) == fixed + 2048 + 2 * 3 * 256 * 128
    assert block_attn.attention_smem(4096, H100_SMEM, True) == H100_SMEM
    assert block_attn.attention_smem(4097, H100_SMEM, True) == 0
    assert block_attn.attention_smem(20480, H100_SMEM, False) == fixed + 2 * 3 * 256 * 128


def test_limits_and_fits():
    assert block_attn.max_seq(BF16, H100_SMEM) == 4096
    assert block_attn.max_seq(F32, H100_SMEM) == 192
    assert block_attn.max_seq(BF16, 100_000) == 192
    for S in (1, 17, 150, 197, 256, 257, 577, 4096):
        assert block_attn.fits(64, S, 768, 12, BF16, H100_SMEM)
    assert not block_attn.fits(64, 4097, 768, 12, BF16, H100_SMEM)
    assert block_attn.fits(4, 192, 1024, 16, F32, H100_SMEM)
    assert not block_attn.fits(4, 193, 1024, 16, F32, H100_SMEM)
    for D in (256, 512, 768, 1024):
        assert block_attn.fits(2, 40, D, D // 64, BF16, H100_SMEM)
    assert not block_attn.fits(2, 40, 384, 6, BF16, H100_SMEM)  # D not a kernel width
    assert not block_attn.fits(2, 40, 768, 24, BF16, H100_SMEM)  # head_dim 32
    assert not block_attn.fits(65536, 40, 768, 12, BF16, H100_SMEM)  # grid y
    assert not block_attn.fits(2, 0, 768, 12, BF16, H100_SMEM)


def test_scratch_shapes():
    assert block_attn.scratch_shape(64, 197, 768, BF16) == (6, 64, 197, 768)
    assert block_attn.scratch_shape(4, 150, 1024, F32) == (1, 4, 150, 1024)


def test_gemm_wrapper_checks_shapes():
    a, w, b = torch.zeros(10, 768, dtype=BF16), torch.zeros(2304, 768, dtype=BF16), \
        torch.zeros(2304)
    with pytest.raises(ValueError, match="multiples of 128"):
        block_attn.gemm_bf16(a, w[:2300], b[:2300])
    with pytest.raises(ValueError, match="N = 3·split"):
        block_attn.gemm_bf16(a, w, b, split=640)
    with pytest.raises(ValueError, match="K of 64"):
        block_attn.gemm_bf16(a[:, :700], w[:, :700], b)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        block_attn.gemm_bf16(a, w, b, split=768)


class _StandIn:
    """A tensor that reports a CUDA device: shape, dim and requires_grad of
    the CPU tensor it wraps."""

    def __init__(self, t, requires_grad=False):
        self.t, self.requires_grad = t, requires_grad
        self.device, self.shape, self.dtype = torch.device("cuda"), t.shape, t.dtype

    def dim(self):
        return self.t.dim()


@pytest.fixture
def recorders(monkeypatch):
    """Replace each wrapper's ``_launch`` and autograd Function by recorders
    of which one a call entered."""
    calls = []
    for mod, fn in ((block_attn, block_attn._KernelBlock), (layernorm, layernorm._KernelLayerNorm)):
        monkeypatch.setattr(mod, "_launch", lambda *a, m=mod: calls.append((m, "launch")))
        monkeypatch.setattr(fn, "apply", lambda *a, m=mod: calls.append((m, "function")))
    monkeypatch.setattr(_build, "smem_optin", lambda device: H100_SMEM)
    return calls


def _block_args(grad_on):
    B, S, D = 2, 9, 256
    ts = [torch.zeros(B, S, D, dtype=BF16), torch.zeros(3 * D, D, dtype=BF16),
          torch.zeros(3 * D), torch.zeros(D, D, dtype=BF16), torch.zeros(D)]
    return [_StandIn(t, requires_grad=(i == grad_on)) for i, t in enumerate(ts)]


@pytest.mark.parametrize("grad_on", [None, 0, 1, 4])
def test_block_attn_routes_by_gradient(recorders, grad_on):
    """No input needing a gradient (or grad mode off): ``_launch`` directly;
    any of x, the weights or the biases needing one: the Function."""
    args = _block_args(grad_on)
    block_attn.fused_attention_block(*args, 4)
    want = "launch" if grad_on is None else "function"
    assert recorders == [(block_attn, want)]
    recorders.clear()
    with torch.no_grad():
        block_attn.fused_attention_block(*args, 4)
    assert recorders == [(block_attn, "launch")]


@pytest.mark.parametrize("grad_on", [None, 0, 1, 2])
def test_layernorm_routes_by_gradient(recorders, grad_on):
    ts = [torch.zeros(5, 768, dtype=BF16), torch.ones(768), torch.zeros(768)]
    args = [_StandIn(t, requires_grad=(i == grad_on)) for i, t in enumerate(ts)]
    layernorm.layernorm(*args, eps=1e-6)
    assert recorders == [(layernorm, "launch" if grad_on is None else "function")]
    recorders.clear()
    with torch.inference_mode():
        layernorm.layernorm(*args, eps=1e-6)
    assert recorders == [(layernorm, "launch")]


def test_layernorm_passes_fp32_scale_and_bias_through():
    """fp32 contiguous scale and bias reach the kernel as they are (no copy
    per call); any other dtype or layout is converted once."""
    s = torch.ones(768)
    assert layernorm._fp32_operand(s) is s
    p = torch.nn.Parameter(torch.ones(768))
    assert layernorm._fp32_operand(p) is p
    half = layernorm._fp32_operand(torch.ones(768, dtype=BF16))
    assert half.dtype == F32 and half.is_contiguous()
    strided = layernorm._fp32_operand(torch.ones(2, 768)[:, 0])
    assert strided.is_contiguous() and strided.dtype == F32

