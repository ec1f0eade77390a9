"""The masked attention's host-side geometry (``alpro_tpu_torch.ops.masked_attn``),
on the CPU: the 4-D tensor map each of q, k and v is read through, and the
plan's shared memory for a given opt-in limit.

``map_geometry`` gives dims (hd, S, H, B) and the byte strides of the S, H and
B axes of a (B, H, S, hd) view or a (B, S, H·hd) tensor, exactly what
``csrc/attn_wgmma.cuh`` encodes; ``smem_bytes`` is the figure
``csrc/masked_attn.cu`` reports (the card tests hold the two equal).
The shared memory is an H100's: 232,448 bytes a block may opt in to.
"""

import pytest
import torch

from alpro_tpu_torch.ops import masked_attn, qkv_attn

H100_SMEM = 232_448
B, S, H, HD = 3, 37, 12, 64
D = H * HD


def _heads(x):
    return masked_attn._heads(x, H)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_packed_qkv_views(dtype):
    """Views of one (B, S, 3D) projection: rows 3D apart, heads hd apart."""
    x = torch.zeros(B, S, 3 * D, dtype=dtype)
    es = x.element_size()
    for i in range(3):
        view = x[..., i * D:(i + 1) * D]
        dims, strides = masked_attn.map_geometry(_heads(view))
        assert dims == (HD, S, H, B)
        assert strides == (3 * D * es, HD * es, S * 3 * D * es)
        # the (B, S, H·hd) form the wrapper reads directly gives the same map
        assert masked_attn.map_geometry(view, H) == (dims, strides)


def test_separate_tensors_and_a_wider_buffer():
    """Separate (B, S, D) tensors, and a q whose row stride is neither D nor
    3D: a slice of a (B, S, 4D) buffer."""
    dims, strides = masked_attn.map_geometry(_heads(torch.zeros(B, S, D, dtype=torch.bfloat16)))
    assert dims == (HD, S, H, B) and strides == (2 * D, 2 * HD, 2 * S * D)
    wide = torch.zeros(B, S, 4 * D, dtype=torch.bfloat16)
    dims, strides = masked_attn.map_geometry(_heads(wide[..., D:2 * D]))
    assert dims == (HD, S, H, B) and strides == (8 * D, 2 * HD, 8 * S * D)


def test_contiguous_bhsd():
    t = torch.zeros(B, H, S, HD, dtype=torch.bfloat16)
    assert masked_attn.map_geometry(t) == ((HD, S, H, B), (2 * HD, 2 * S * HD, 2 * H * S * HD))


def test_axes_of_extent_one_take_the_span():
    """An axis that is never stepped takes the view's byte span (rounded up
    to 16) as its stride, whatever stride the view carries."""
    t = torch.zeros(1, 1, S, HD, dtype=torch.bfloat16)
    span = -(-2 * S * HD // 16) * 16
    assert masked_attn.map_geometry(t) == ((HD, S, 1, 1), (2 * HD, span, span))
    bcast = torch.zeros(S, HD, dtype=torch.bfloat16).expand(1, 1, S, HD)
    assert masked_attn.map_geometry(bcast)[1] == (2 * HD, span, span)


@pytest.mark.parametrize("case", ["pointer", "row_stride", "head_dim_strided", "zero_stride"])
def test_unaligned_views_raise(case):
    if case == "pointer":  # the data pointer 4 bytes off 16
        t = _heads(torch.zeros(B, S, 3 * D + 4)[..., 1:D + 1])
    elif case == "row_stride":  # rows 3D + 4 bf16 elements apart: 8 bytes off 16
        t = _heads(torch.zeros(B, S, 3 * D + 4, dtype=torch.bfloat16)[..., :D])
    elif case == "head_dim_strided":
        t = torch.zeros(B, H, HD, S, dtype=torch.bfloat16).transpose(2, 3)
    else:  # a key broadcast over the sequence
        t = torch.zeros(B, H, 1, HD, dtype=torch.bfloat16).expand(B, H, S, HD)
    with pytest.raises(ValueError, match="aligned"):
        masked_attn.map_geometry(t)


@pytest.mark.parametrize("Sk", [1, 40, 197, 237, 256, 257, 513, 709, 1000, 2000])
@pytest.mark.parametrize("hd", [32, 64, 128])
def test_bf16_plan_fits_an_h100(Sk, hd):
    """bf16 fits every length the model gives (709 keys at most) and the
    streamed ones past it; the plan is K1's (the same K/V slots, all
    resident or its ring) plus the bias row, n·R fp32 padded to 1024 bytes."""
    got = masked_attn.smem_bytes(Sk, hd, torch.bfloat16, H100_SMEM)
    assert 0 < got <= H100_SMEM
    max_n = 128 if hd == 128 else 256
    keys = -(-Sk // 64) * 64 if Sk <= max_n else -(-Sk // max_n) * max_n
    bias = -(-keys * 4 // 1024) * 1024
    assert got == qkv_attn.spatial_smem_bytes(Sk, hd, torch.bfloat16, H100_SMEM) + bias


def test_the_main_shapes_plans():
    """K1's plan at the spatial shape is unchanged (83 KB: two CTAs an SM);
    the masked attention adds 1 KB of bias there, and keeps K and V of the
    longest fusion sequence (709 keys, three chunks) resident."""
    assert qkv_attn.spatial_smem_bytes(197, 64, torch.bfloat16, H100_SMEM) == 84_992
    assert masked_attn.smem_bytes(197, 64, torch.bfloat16, H100_SMEM) == 84_992 + 1024
    assert masked_attn.smem_bytes(709, 64, torch.bfloat16, H100_SMEM) == \
        19_456 + 3072 + 3 * 2 * 256 * 64 * 2


@pytest.mark.parametrize("dtype,hd,limit", [
    (torch.bfloat16, 32, 38_912), (torch.bfloat16, 64, 20_480), (torch.bfloat16, 128, 16_128),
    (torch.float32, 32, 848), (torch.float32, 64, 416), (torch.float32, 128, 192)])
def test_limits(dtype, hd, limit):
    """The largest Sk: in bf16 the bias row's (K and V stream), in fp32 K and
    V of one head in shared memory; one past it no launch fits."""
    assert masked_attn.max_keys(dtype, hd, H100_SMEM) == limit
    assert masked_attn.smem_bytes(limit, hd, dtype, H100_SMEM) > 0
    assert masked_attn.smem_bytes(limit + 1, hd, dtype, H100_SMEM) == 0
    assert masked_attn.smem_bytes(1, 48, dtype, H100_SMEM) == 0  # no kernel's head_dim
