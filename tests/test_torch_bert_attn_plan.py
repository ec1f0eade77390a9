"""K4's host-side plan (``alpro_tpu_torch.ops.bert_block``), on the CPU.

The bf16 launch of ``bert_attention_block`` is four kernels behind one C
call (``csrc/bert_attn.cu``): the packed q/k/v GEMM, the masked attention on
views of its (M·S, 3D) scratch, the output projection into fp32 partials
cut along its K axis (``proj_plan``), the finalize. Here: the K-slice plan
at the main path's shapes, the q/k/v geometry the attention reads from the
scratch (``qkv_geometry``, which the C function ``packed_operand`` mirrors)
against ``masked_attn.map_geometry`` of the same views, and which bias and
LN vectors the wrapper hands the kernel as they are (no cast launches). An
H100 has 132 SMs.
"""

import pytest
import torch

from alpro_tpu_torch.ops import _build, bert_block, masked_attn

SMS = 132
BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("M,S,k_split,splits", [(1, 40, 64, 12), (8, 40, 64, 12),
                                                (8, 237, 384, 2), (16, 237, 768, 1)])
def test_proj_plan_at_the_main_path_shapes(M, S, k_split, splits):
    """One text query and a batch of 8 (S = 40), the fusion of 8 and of 16
    candidates (S = 40 + 197) at D = 768: the projection's 128 x 128 tiles,
    times the slices, stay within one wave of two CTAs an SM; 6 tiles at
    R = 40 take all twelve 64-column slices, 90 at R = 1896 two."""
    R, D = M * S, 768
    assert bert_block.proj_plan(R, D, SMS) == (k_split, splits)
    assert splits == -(-D // k_split) and k_split % 64 == 0
    assert -(-R // 128) * (D // 128) * splits <= 2 * SMS


@pytest.mark.parametrize("M,S,D,H", [(1, 40, 768, 12), (8, 40, 768, 12), (8, 237, 768, 12),
                                     (16, 237, 768, 12), (1, 709, 768, 12), (3, 1, 256, 4),
                                     (2, 17, 1024, 16)])
def test_qkv_geometry_is_the_views_map_geometry(M, S, D, H):
    """q, k and v at offsets 0, D and 2D of each (3D)-wide scratch row, the
    rows (M, S) apart by 3D elements: the tensor maps of the views a packed
    qkv projection gives the masked attention."""
    scratch = torch.zeros(M * S, 3 * D, dtype=BF16)
    packed = scratch.view(M, S, 3 * D)
    geometry = bert_block.qkv_geometry(M, S, D, H)
    assert len(geometry) == 3
    for i, (offset, dims, strides) in enumerate(geometry):
        view = packed[..., i * D:(i + 1) * D]
        assert view.data_ptr() - scratch.data_ptr() == offset
        assert masked_attn.map_geometry(view, H, "qkv") == (dims, strides)


def test_bf16_vectors_go_in_without_a_cast(monkeypatch):
    """All six bias and LN vectors bf16 beside bf16 x: handed over as they
    are (the kernels widen them on load); any one in another dtype: all six
    in fp32, which holds every bf16 value exactly; fp32 x: fp32."""
    monkeypatch.setattr(_build, "check_cuda_operand", lambda *a, **k: None)
    g = torch.Generator().manual_seed(0)
    vecs = tuple(torch.randn(768, generator=g).to(BF16) for _ in range(6))
    x = torch.zeros(1, 2, 768, dtype=BF16)
    got, flag = bert_block._vectors(x, vecs)
    assert flag == 1 and all(a is b for a, b in zip(got, vecs))
    mixed = vecs[:4] + tuple(v.float() for v in vecs[4:])
    for x_dtype, given in ((BF16, mixed), (F32, vecs)):
        got, flag = bert_block._vectors(x.to(x_dtype), given)
        assert flag == 0 and all(v.dtype == F32 for v in got)
        assert all(torch.equal(a, b.float()) for a, b in zip(got, vecs))
