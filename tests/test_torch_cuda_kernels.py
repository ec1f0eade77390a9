"""The port's CUDA kernels against their plain twins, on the card.

Every test carries the ``cuda`` marker and skips without a CUDA device. The
file imports only torch and the port (no jax), so it runs on the machine with
the GPU: ``python -m pytest tests/test_torch_cuda_kernels.py -m cuda``.
Tolerances: bf16 outputs within a few bf16 ulps of the twin (the spatial
kernel rounds p to bf16 before PV, and the BERT attention kernel q, k, v and
p as its TPU kernel does, where the twins keep fp32; the masked-attention
kernel rounds where its twin does, so only summation order and exp differ);
fp32 within summation-order noise. Gradients: K1/K2, the masked attention,
the raw-frame patch embed (B15) and the LayerNorm kernel (B14) through their
autograd Functions against autograd through the twins; K3-K5, the fused
ingest's B9, B10 and B11 and the opt-in serving kernels B6, B7 and B8 refuse
grad. The CLS-sideband attention (B6) rounds p like K1 except the CLS
column's, so bf16 takes K1's tolerance; B7, B8 and B14 round where their
twins do. B16 is K2's kernel over its whole envelope (head_dim a multiple of
8 up to 128, T up to 128): K2's tolerance. B17 keeps q, k, v in fp32 where
its twin rounds them (its TPU kernel's rounding points): bf16 within 2e-2;
with scores in the tens it matches the contract reference at 2e-2 where the
twin, rounding q and k, misses it by 5x that. B17's GEMM alone against the
fp32 product: within the bf16 rounding of the result (split: hi + lo within
2^-15 of it). B9 and B7 carry q, k, v (B9) and p as bf16 hi + lo pairs
in bf16: within 2e-2 of their twins, which keep them in fp32 (the TPU
kernels' contract), up to 2048 keys; B9 with scores in the tens too, where
the twin with q and k rounded misses by 5x that; the layer's bf16 vectors
read as they are give their fp32 copies' result bit for bit. B11's bf16
route (LN rows, then the TMA/wgmma GEMM) against ``ln_matmul_plain``, its
TPU kernel's contract, within one output ulp, at R 12608, 12544, 6304, 45
and 1 and F 896 and 384 past the old F % 768; B10's bf16 route against
``fused_temporal_block_reference`` (q, k, v rounded) within one ulp and
2^-7, on K2's fast and wide paths (T up to 48); its qkv scratch bit-equal to
B11's output and its heads to K2's own instantiation; past ``fits`` and
``temporal_fits`` the C side refuses too. K2's TMA-staged fast path and B16
at every head_dim (8 to 128) and T (1 to 32) edge, K2's tolerance. B8's
bf16 route (K2's body into a heads scratch, then the GEMM) within 2e-2 of
its twin up to T = 128, with a bf16 or fp32 b_eff; its heads bit-equal to
K2's own launch; its output holding the per-head rounding where a route
that keeps o in fp32 misses by 10x the kernel's mean miss; past
``temporal_proj_fits`` the C side refuses. B14, B17, K4, B9, B7, B11, B10,
K2 and B8 launch on the current stream: under ``torch.cuda.stream(s)``
(their result ready on s while the default stream still sleeps) and inside
a CUDA-graph capture (a replay on new inputs).
K1 and B13, called 20 000 times each on the same (64, 197) input, give the
first call's output bit for bit.
The limit predicates that ``auto`` reads agree with what the kernels take:
S at the Python limit launches, one past it raises ``ValueError``, and
where the C side reports a limit the two are equal.
The exact GELU (``ops/gelu.py``, no TPU counterpart): its forward bit-equal
to the twin in bf16 and fp32 at the QA training path's (75264, 3072), the
CLS rows' (24, 3072) and sizes with n mod 8 not 0, on special values and an
unaligned view; its backward within one bf16 ulp (four fp32 ulps) of
autograd through the twin; repeats bit-equal; a non-contiguous input or
another dtype refused; on the current stream and in a graph capture; a
checkpointed divided block under ``dots_ln`` and ``nothing`` against the
plain block; the launches of one QA micro-step by the model's depth.
"""

import pytest
import torch

from alpro_tpu_torch.ops import (_build, block_attn, bert_block, fused_block, ln_mlp,
                                 masked_attn, qkv_attn, temporal_attn)
from alpro_tpu_torch.ops.kernel_math import ln_rows_f32

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, seed, device, dtype, std=1.0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * std).to(device, dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,S", [(16, 197), (3, 17), (2, 64)])
def test_spatial_kernel_matches_twin(cuda, M, S, dtype):
    H, hd = 12, 64
    x = _randn((M, S, 3 * H * hd), S, cuda, dtype)
    n = qkv_attn.spatial_launches
    got = qkv_attn.spatial_attention_qkv(x, H)
    torch.cuda.synchronize()
    assert qkv_attn.spatial_launches == n + 1
    want = qkv_attn.spatial_attention_plain(x, H, hd ** -0.5)
    tol = 3e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


# the bf16 attention body K1 and B13 share (csrc/attn_wgmma.cuh) refills a
# query buffer by TMA after reading it with ldmatrix; without the proxy fence
# between the two, about one (64, 197) call in 1300 gave other outputs on an
# H100: 20 000 calls each must all equal the first, bit for bit
_REPEATS = 20000


@pytest.mark.parametrize("kernel", ["spatial", "masked"])
def test_attention_body_repeats_bit_equal(cuda, kernel):
    H, M, S = 12, 64, 197
    x = _randn((M, S, 3 * H * 64), 7, cuda, torch.bfloat16)
    q, k, v = x[..., :768], x[..., 768:1536], x[..., 1536:]
    call = {"spatial": lambda: qkv_attn.spatial_attention_qkv(x, H),
            "masked": lambda: masked_attn.fused_attention_bshd(q, k, v, H)}[kernel]
    first = call()
    differ = sum(not torch.equal(call(), first) for _ in range(_REPEATS))
    assert differ == 0, f"{differ} of {_REPEATS} calls differ from the first"


# K1's and B6's envelope: S across the query-tile (64) and key-chunk edges
# (256, 128 at head_dim 128), the two-pass lengths of 256², 384² and 400²
# frames (257, 577, 640) and lengths whose K and V no longer all fit in
# shared memory (1000 at head_dim 64 and 128, 2000 at 32: streamed through
# the TMA ring); M·H = 276 blocks, above two per SM on 132 SMs
_SPATIAL_SEQS = [1, 15, 16, 17, 65, 196, 197, 257, 577, 640, 1000, 2000]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("S", _SPATIAL_SEQS)
def test_spatial_kernel_envelope_matches_twin(cuda, S, hd, dtype):
    M, H = 23, 12
    x = _randn((M, S, 3 * H * hd), S + hd, cuda, dtype)
    n = qkv_attn.spatial_launches
    got = qkv_attn.spatial_attention_qkv(x, H)
    torch.cuda.synchronize()
    assert qkv_attn.spatial_launches == n + 1
    want = qkv_attn.spatial_attention_plain(x, H, hd ** -0.5)
    tol = 3e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", [32, 64, 128])
@pytest.mark.parametrize("S", _SPATIAL_SEQS)
def test_spatial_cls_kernel_envelope_matches_twin(cuda, S, hd, dtype):
    """B6 at N = S - 1 patches (S = 1: the CLS row alone is not a frame, so
    N = 1 there); T = 8 frames per sample, M = 24 frames."""
    B, T, H, N = 3, 8, 12, max(S - 1, 1)
    qx = _randn((B * T, N, 3 * H * hd), N + hd, cuda, dtype)
    qc = _randn((B, 1, 3 * H * hd), hd, cuda, dtype)
    n = qkv_attn.spatial_cls_launches
    got = qkv_attn.spatial_attention_qkv_cls(qx, qc, H, T)
    torch.cuda.synchronize()
    assert qkv_attn.spatial_cls_launches == n + 1
    want = qkv_attn.spatial_attention_qkv_cls_plain(qx, qc, H, hd ** -0.5, T)
    tol = 3e-2 if dtype == torch.bfloat16 else 1e-5
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T", [1, 8, 16])
def test_temporal_kernel_matches_twin(cuda, T, dtype):
    B, N, H, hd = 2, 196, 12, 64
    x = _randn((B, T, N, 3 * H * hd), T, cuda, dtype)
    n = qkv_attn.temporal_launches
    got = qkv_attn.temporal_attention_qkv(x, H)
    torch.cuda.synchronize()
    assert qkv_attn.temporal_launches == n + 1
    want = qkv_attn.temporal_attention_plain(x, H, hd ** -0.5)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


# R across the bf16 plan's branches (ln_mlp.bf16_plan on 132 SMs): 24 slices
# of fc2's hidden up to one 128-row tile (1-128), 16 past it (129), 12 at
# 320, 2 at 1896, one slice from 3136 (K3: fc2 rounds into the output, no
# partials); D 256 and 1024 and Dh 1024 as in the narrow models `auto` takes
_MLP_CASES = [(R, True, 768, 3072) for R in (1, 8, 40, 127, 128, 129, 1896, 3792, 12544)] + [
    (8, False, 768, 3072), (12544, False, 768, 3072), (40, True, 256, 1024),
    (3136, True, 256, 1024), (129, True, 1024, 4096), (1896, True, 1024, 4096),
    (300, True, 768, 1024)]


def _mlp_dtype_cases(cases):
    """Each case in bf16 and, where the fp32 row kernel takes its D, fp32."""
    return [(*c, dt) for c in cases for dt in (torch.bfloat16, torch.float32)
            if ln_mlp.ln_mlp_fits(c[-2], c[-1], dt)]


@pytest.mark.parametrize("R,residual,D,Dh,dtype", _mlp_dtype_cases(
    [(3136, True, 768, 3072), (2, False, 768, 3072), (45, True, 768, 3072)] + _MLP_CASES))
def test_ln_mlp_kernel_matches_twin(cuda, R, residual, D, Dh, dtype):
    args = (
        _randn((R, D), R, cuda, dtype, 2.0),
        1 + _randn((D,), 1, cuda, torch.float32, 0.1),
        _randn((D,), 2, cuda, torch.float32, 0.1),
        _randn((Dh, D), 3, cuda, dtype, D ** -0.5),
        _randn((Dh,), 4, cuda, dtype, 0.1),
        _randn((D, Dh), 5, cuda, dtype, Dh ** -0.5),
        _randn((D,), 6, cuda, dtype, 0.1),
    )
    n = ln_mlp.launches
    got = ln_mlp.ln_mlp(*args, eps=1e-6, residual=residual)
    torch.cuda.synchronize()
    assert ln_mlp.launches == n + 1
    want = ln_mlp.ln_mlp_plain(*args, eps=1e-6, residual=residual)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_kernels_reject_what_they_do_not_take(cuda):
    strided = torch.zeros(4, 9, 2 * 3 * 64, device=cuda)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        qkv_attn.spatial_attention_qkv(strided, 1)
    with pytest.raises(ValueError, match="dtype"):
        qkv_attn.temporal_attention_qkv(torch.zeros(1, 2, 3, 192, device=cuda,
                                                    dtype=torch.float16), 1)
    with pytest.raises(ValueError, match="T <= 128"):
        qkv_attn.temporal_attention_qkv(torch.zeros(1, 129, 1, 192, device=cuda), 1)
    with pytest.raises(ValueError, match="head_dim a multiple of 8"):
        qkv_attn.temporal_attention_qkv(torch.zeros(1, 4, 1, 3 * 36, device=cuda), 1)
    x = torch.zeros(2, 768, device=cuda, dtype=torch.bfloat16)
    w = torch.zeros(3072, 768, device=cuda)  # fp32 weights for bf16 rows
    v = torch.zeros(768, device=cuda)
    with pytest.raises(ValueError, match="dtype"):
        ln_mlp.ln_mlp(x, v, v, w, torch.zeros(3072, device=cuda), w.t().contiguous(), v,
                      eps=1e-6)


def test_mlp_kernels_raise_past_the_fp32_width(cuda):
    """fp32's row kernel stops at D = 768 (its shared memory at 1024 is past
    a block's): the wrappers raise naming the limit and launch nothing,
    where bf16 takes D = 1024."""
    D, Dh = 1024, 4096
    x = _randn((4, D), 0, cuda, torch.float32)
    w1, w2 = _randn((Dh, D), 1, cuda, torch.float32), _randn((D, Dh), 2, cuda, torch.float32)
    b1, v = torch.zeros(Dh, device=cuda), torch.ones(D, device=cuda)
    n, nb = ln_mlp.launches, bert_block.mlp_launches
    with pytest.raises(ValueError, match="in fp32"):
        ln_mlp.ln_mlp(x, v, v, w1, b1, w2, v, eps=1e-6)
    with pytest.raises(ValueError, match="in fp32"):
        bert_block.bert_mlp_block(x, w1, b1, w2, v, v, v, eps=1e-12)
    assert (ln_mlp.launches, bert_block.mlp_launches) == (n, nb)
    bf = torch.bfloat16
    got = ln_mlp.ln_mlp(x.to(bf), v, v, w1.to(bf), b1, w2.to(bf), v, eps=1e-6)
    assert got.shape == (4, D) and ln_mlp.launches == n + 1


def _bert_attn_args(M, S, cuda, dtype, seed=0, w_std=768 ** -0.5):
    D = 768
    g = torch.Generator().manual_seed(seed)
    mask = torch.ones(M, S)
    for m in range(M):  # padding tails of different lengths
        mask[m, S - (m * 7) % max(S // 2, 1):] = 0.0
    mask[:, 0] = 1.0
    ws = []
    for _ in range(4):
        ws += [_randn((D, D), int(torch.randint(1 << 30, (1,), generator=g)), cuda, dtype,
                      w_std),
               _randn((D,), int(torch.randint(1 << 30, (1,), generator=g)), cuda, dtype, 0.1)]
    ln = (1 + _randn((D,), 7, cuda, torch.float32, 0.1), _randn((D,), 8, cuda, torch.float32, 0.1))
    return _randn((M, S, D), S + M, cuda, dtype), mask.to(cuda), ws, ln


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,S", [(1, 40), (8, 237), (16, 237), (3, 17)])
def test_bert_attn_kernel_matches_twin(cuda, M, S, dtype):
    x, mask, ws, ln = _bert_attn_args(M, S, cuda, dtype)
    n = bert_block.attn_launches
    got = bert_block.bert_attention_block(x, mask, *ws, *ln, 12, eps=1e-12)
    torch.cuda.synchronize()
    assert bert_block.attn_launches == n + 1
    want = bert_block.bert_attention_block_plain(x, mask, *ws, *ln, 12, 1e-12)
    tol = 3e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_bert_attn_kernel_takes_the_longest_fusion_sequence(cuda):
    """512 text positions + 197 video tokens, in bf16; fp32 has a lower
    limit, and past it the wrapper raises naming it, as bf16 does past its
    own."""
    x, mask, ws, ln = _bert_attn_args(1, 512 + 197, cuda, torch.bfloat16, seed=1)
    got = bert_block.bert_attention_block(x, mask, *ws, *ln, 12, eps=1e-12)
    want = bert_block.bert_attention_block_plain(x, mask, *ws, *ln, 12, 1e-12)
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=3e-2)
    n = bert_block.attn_launches
    limit = bert_block.max_seq_len(torch.bfloat16, cuda)
    long_x = torch.zeros(1, limit + 1, 768, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=f"S <= {limit}"):
        bert_block.bert_attention_block(long_x, torch.ones(1, limit + 1, device=cuda), *ws, *ln,
                                        12, eps=1e-12)
    limit = bert_block.max_seq_len(torch.float32, cuda)
    x, mask, ws, ln = _bert_attn_args(1, limit + 1, cuda, torch.float32)
    with pytest.raises(ValueError, match=f"S <= {limit}"):
        bert_block.bert_attention_block(x, mask, *ws, *ln, 12, eps=1e-12)
    assert bert_block.attn_launches == n


@pytest.mark.parametrize("M,S", [(1, 2048), (2, 1000), (3, 257)])
def test_bert_attn_kernel_past_the_old_limit(cuda, M, S):
    """bf16 past the 752 keys that K and V of a head in shared memory
    allowed, and past one 256-key chunk: the attention walks the keys twice
    (the exact row max, then exp, sum and P·V), K and V streamed past what
    stays resident; against the twin at the twin tolerance."""
    x, mask, ws, ln = _bert_attn_args(M, S, cuda, torch.bfloat16, seed=2)
    got = bert_block.bert_attention_block(x, mask, *ws, *ln, 12, eps=1e-12)
    want = bert_block.bert_attention_block_plain(x, mask, *ws, *ln, 12, 1e-12)
    torch.testing.assert_close(got.float(), want.float(), atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("M,S", [(8, 237), (1, 40)])
def test_bert_attn_kernel_holds_the_tpu_contract(cuda, M, S):
    """q/k/v/o weights at std 4·D^-½ (scores in the tens) and every vector
    bf16, as the serving layer passes them: the kernel against
    ``bert_attention_block_reference`` (q, k and v rounded to bf16 after the
    fp32 bias, as the TPU kernel rounds them) within 2e-2. A kernel that
    kept q or k in fp32, or rounded p after the division, would miss it."""
    x, mask, ws, ln = _bert_attn_args(M, S, cuda, torch.bfloat16, seed=3,
                                      w_std=4 * 768 ** -0.5)
    ln = tuple(v.to(torch.bfloat16) for v in ln)
    got = bert_block.bert_attention_block(x, mask, *ws, *ln, 12, eps=1e-12)
    want = bert_block.bert_attention_block_reference(x, mask, *ws, *ln, 12, 1e-12)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("R,D,Dh,dtype", _mlp_dtype_cases(
    [(40, 768, 3072), (320, 768, 3072), (1896, 768, 3072), (3, 768, 3072)]
    + [(R, D, Dh) for R, residual, D, Dh in _MLP_CASES
       if residual and (R, D) not in ((40, 768), (1896, 768))]))
def test_bert_mlp_kernel_matches_twin(cuda, R, D, Dh, dtype):
    args = (
        _randn((R, D), R, cuda, dtype, 2.0),
        _randn((Dh, D), 3, cuda, dtype, D ** -0.5),
        _randn((Dh,), 4, cuda, dtype, 0.1),
        _randn((D, Dh), 5, cuda, dtype, Dh ** -0.5),
        _randn((D,), 6, cuda, dtype, 0.1),
        1 + _randn((D,), 1, cuda, torch.float32, 0.1),
        _randn((D,), 2, cuda, torch.float32, 0.1),
    )
    n = bert_block.mlp_launches
    got = bert_block.bert_mlp_block(*args, eps=1e-12)
    torch.cuda.synchronize()
    assert bert_block.mlp_launches == n + 1
    want = bert_block.bert_mlp_block_plain(*args, 1e-12)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_bert_kernels_reject_what_they_do_not_take(cuda):
    x, mask, ws, ln = _bert_attn_args(1, 8, cuda, torch.float32)
    with pytest.raises(ValueError, match="head_dim 64"):
        bert_block.bert_attention_block(x, mask, *ws, *ln, 8, eps=1e-12)
    with pytest.raises(ValueError, match="dtype"):
        bert_block.bert_attention_block(x.to(torch.bfloat16), mask, *ws, *ln, 12, eps=1e-12)
    with pytest.raises(ValueError, match="Dh"):
        bert_block.bert_mlp_block(x[0], torch.zeros(100, 768, device=cuda),
                                  torch.zeros(100, device=cuda),
                                  torch.zeros(768, 100, device=cuda), ln[1], *ln, eps=1e-12)


# ---- masked attention (B12 / B13) and the kernels' gradients ----------------


def _attn_inputs(layout, Bn, S, cuda, dtype, seed=0, form="separate", hd=64, Sq=None,
                 dead=False):
    """q, k, v over 12 heads of ``hd`` and a key mask with padded tails of
    different lengths (``dead``: the first sequence's keys all masked). bshd:
    (B, S, 12·hd) — views of one packed (B, S, 3D) projection when ``form``
    is 'packed', slices of (B, S, 4D) buffers (rows neither D nor 3D apart)
    when 'wide'; bhsd: (B, 12, S, hd). Sq (default S) query rows."""
    H = 12
    D, Sq = H * hd, S if Sq is None else Sq
    if layout == "bshd" and form == "packed":
        x = _randn((Bn, S, 3 * D), seed, cuda, dtype)
        q, k, v = x[..., :D], x[..., D:2 * D], x[..., 2 * D:]
    elif layout == "bshd" and form == "wide":
        xq, xkv = _randn((Bn, Sq, 4 * D), seed, cuda, dtype), _randn((Bn, S, 4 * D), seed + 1,
                                                                       cuda, dtype)
        q, k, v = xq[..., D:2 * D], xkv[..., 3 * D:], xkv[..., :D]
    elif layout == "bshd":
        q, k, v = (_randn((Bn, s, D), seed + i, cuda, dtype) for i, s in enumerate((Sq, S, S)))
    else:
        q, k, v = (_randn((Bn, H, s, hd), seed + i, cuda, dtype)
                   for i, s in enumerate((Sq, S, S)))
    mask = torch.ones(Bn, S, device=cuda)
    for b in range(Bn):
        mask[b, max(1, S - (b * 11) % max(S // 2, 1)):] = 0.0
    if dead:
        mask[0] = 0.0
    return q, k, v, mask


def _attn(layout, q, k, v, mask):
    if layout == "bshd":
        return masked_attn.fused_attention_bshd(q, k, v, 12, key_mask=mask)
    return masked_attn.fused_attention(q, k, v, key_mask=mask)


def _attn_twin(layout, q, k, v, mask):
    hd = q.shape[-1] // 12 if layout == "bshd" else q.shape[-1]
    bias = masked_attn.key_bias(mask, q.shape[0], mask.shape[1], q.device)
    if layout == "bshd":
        heads = [t.unflatten(-1, (12, hd)).transpose(1, 2) for t in (q, k, v)]
        return masked_attn.attention_plain(*heads, bias, hd ** -0.5).transpose(1, 2).flatten(2)
    return masked_attn.attention_plain(q, k, v, bias, hd ** -0.5)


# (layout, Bn, Sq, Sk, hd, form, dead, dtype): the finetuning path's shapes
# (text (8, 40), spatial (64, 197) on views of the packed qkv, fusion (24,
# 237), the longest fusion sequence (1, 709): 12 CTAs, so its query tiles
# split over the grid) in both dtypes; in bf16 the key counts about the
# one-pass chunk (255, 256, 257; 128 at head_dim 128), two and four chunks
# (513, 1000: streamed past what stays resident) at every head_dim, Sq != Sk
# both ways, a sequence whose keys are all masked, and bshd slices of wider
# buffers
_BF, _F32 = torch.bfloat16, torch.float32
_MASKED_CASES = (
    [(layout, Bn, S, S, 64, "packed" if S == 197 else "separate", False, dtype)
     for dtype in (_BF, _F32) for Bn, S in ((8, 40), (64, 197), (24, 237), (1, 709))
     for layout in ("bshd", "bhsd")]
    + [(layout, 3, S, S, hd, "separate", False, _BF) for layout in ("bshd", "bhsd")
       for hd in (32, 64, 128) for S in (255, 256, 257, 513, 1000)]
    + [("bhsd", 24, 40, 237, 64, "separate", False, _BF),
       ("bshd", 2, 700, 60, 64, "separate", False, _BF),
       ("bshd", 8, 40, 40, 64, "separate", True, _BF),
       ("bhsd", 2, 300, 300, 128, "separate", True, _BF),
       ("bshd", 8, 197, 197, 64, "wide", False, _BF),
       ("bshd", 2, 40, 300, 32, "wide", True, _BF)]
)


@pytest.mark.parametrize("layout,Bn,Sq,Sk,hd,form,dead,dtype", _MASKED_CASES)
def test_masked_attn_kernel_matches_twin(cuda, layout, Bn, Sq, Sk, hd, form, dead, dtype):
    if dtype == torch.float32 and Sk > masked_attn.max_seq_len(dtype, hd, cuda):
        pytest.skip(f"fp32 takes S <= {masked_attn.max_seq_len(dtype, hd, cuda)}; the raise "
                    "is tested below")
    q, k, v, mask = _attn_inputs(layout, Bn, Sk, cuda, dtype, form=form, hd=hd, Sq=Sq,
                                 dead=dead)
    n = (masked_attn.bshd_launches, masked_attn.bhsd_launches)
    got = _attn(layout, q, k, v, mask)
    torch.cuda.synchronize()
    want = (n[0] + 1, n[1]) if layout == "bshd" else (n[0], n[1] + 1)
    assert (masked_attn.bshd_launches, masked_attn.bhsd_launches) == want
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), _attn_twin(layout, q, k, v, mask).float(),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("layout", ["bshd", "bhsd"])
def test_masked_attn_backward_matches_twin_autograd(cuda, layout):
    """fp32: the Function's backward (the JAX recompute) against autograd
    through the twin, to summation order; bf16 runs and is finite."""
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, None)):
        q, k, v, mask = _attn_inputs(layout, 4, 197, cuda, dtype, seed=3)
        ts = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        out = _attn(layout, *ts, mask)
        g = torch.randn(out.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(0))
        got = torch.autograd.grad(out, ts, g.to(dtype))
        assert all(d.dtype == dtype and bool(torch.isfinite(d).all()) for d in got)
        if tol is None:
            continue
        refs = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        want = torch.autograd.grad(_attn_twin(layout, *refs, mask), refs, g)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, atol=tol, rtol=tol)


def test_masked_attn_raises_past_its_limit(cuda):
    limit = masked_attn.max_seq_len(torch.float32, 64, cuda)
    assert masked_attn.max_seq_len(torch.bfloat16, 64, cuda) >= 709
    q, k, v, mask = _attn_inputs("bshd", 1, limit + 1, cuda, torch.float32)
    with pytest.raises(ValueError, match=f"Sk <= {limit}"):
        _attn("bshd", q, k, v, mask)
    with pytest.raises(ValueError, match="aligned"):
        x = torch.zeros(1, 4, 3 * 768 + 1, device=cuda)
        _attn("bshd", x[..., 1:769], x[..., 769:1537], x[..., 1537:], None)


@pytest.mark.parametrize("kind", ["spatial", "temporal"])
def test_qkv_kernel_gradients_match_twin(cuda, kind):
    """K1/K2 under autograd: the kernel forward, and a backward (the twin's
    vjp) equal to autograd through the twin."""
    if kind == "spatial":
        x0 = _randn((16, 197, 3 * 768), 11, cuda, torch.float32)
        fn, twin = qkv_attn.spatial_attention_qkv, qkv_attn.spatial_attention_plain
    else:
        x0 = _randn((2, 8, 196, 3 * 768), 12, cuda, torch.float32)
        fn, twin = qkv_attn.temporal_attention_qkv, qkv_attn.temporal_attention_plain
    x = x0.clone().requires_grad_(True)
    out = fn(x, 12)
    assert out.grad_fn is not None
    g = torch.randn(out.shape, device=cuda, generator=torch.Generator(cuda).manual_seed(1))
    (got,) = torch.autograd.grad(out, x, g)
    ref = x0.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(twin(ref, 12, 0.125), ref, g)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_serving_kernels_refuse_grad(cuda):
    """K3-K5 have no backward: under grad with an input that requires grad
    they raise instead of returning a tensor without a grad_fn; under
    no_grad they run."""
    D, Dh = 768, 3072
    x = _randn((40, D), 0, cuda, torch.float32)
    w1 = _randn((Dh, D), 1, cuda, torch.float32, D ** -0.5).requires_grad_(True)
    b1 = torch.zeros(Dh, device=cuda)
    w2 = _randn((D, Dh), 2, cuda, torch.float32, Dh ** -0.5)
    b2, s, b = torch.zeros(D, device=cuda), torch.ones(D, device=cuda), torch.zeros(D, device=cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        ln_mlp.ln_mlp(x, s, b, w1, b1, w2, b2, eps=1e-6)
    with pytest.raises(RuntimeError, match="no backward"):
        bert_block.bert_mlp_block(x, w1, b1, w2, b2, s, b, eps=1e-12)
    xa, mask, ws, ln = _bert_attn_args(1, 40, cuda, torch.float32)
    with pytest.raises(RuntimeError, match="no backward"):
        bert_block.bert_attention_block(xa.requires_grad_(True), mask, *ws, *ln, 12, eps=1e-12)
    with torch.no_grad():
        assert ln_mlp.ln_mlp(x, s, b, w1, b1, w2, b2, eps=1e-6).shape == (40, D)


# ---- the fused video ingest: B11, B15, B10, B9 -------------------------------


def _block_weights(cuda, dtype, seed=0, D=768):
    """ln scale, ln bias (fp32), wqkv (3D, D), bqkv, w (D, D), b."""
    return (1 + _randn((D,), seed, cuda, torch.float32, 0.1),
            _randn((D,), seed + 1, cuda, torch.float32, 0.1),
            _randn((3 * D, D), seed + 2, cuda, dtype, D ** -0.5),
            _randn((3 * D,), seed + 3, cuda, dtype, 0.02),
            _randn((D, D), seed + 4, cuda, dtype, D ** -0.5),
            _randn((D,), seed + 5, cuda, dtype, 0.02))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("R", [12608, 12544, 45])
def test_ln_matmul_kernel_matches_twin(cuda, R, dtype):
    from alpro_tpu_torch.ops import ln_matmul

    s, b, w, bw, _, _ = _block_weights(cuda, dtype, seed=R)
    x = _randn((R, 768), R, cuda, dtype, 2.0)
    n = ln_matmul.launches
    got = ln_matmul.ln_matmul(x, s, b, w, bw, eps=1e-6)
    torch.cuda.synchronize()
    assert ln_matmul.launches == n + 1 and got.shape == (R, 2304)
    want = ln_matmul.ln_matmul_plain(x, s, b, w, bw, 1e-6)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


# B11's bf16 route rounds where its contract reference (ln_matmul_plain)
# does, so only fp32 sums differ in order: one bf16 ulp of the output. B10
# rounds q, k, v and the per-head output to bf16 at fp32 values that differ
# from the reference's in their last bits, so a few of those roundings land
# one ulp apart, and the projection carries that (|w_eff| · ulp(o), up to a
# few 1e-3 in a row): one ulp and 2^-7 absolute
ULP_ATOL, ULP_RTOL = 2 ** -8, 2 ** -7
B10_ATOL, B10_RTOL = 2 ** -7, 2 ** -7


@pytest.mark.parametrize("vec_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("R,D,F", [(12608, 768, 2304), (12544, 768, 2304), (6304, 768, 2304),
                                   (45, 768, 2304), (300, 768, 896), (77, 64, 128),
                                   (130, 1024, 384), (1, 512, 1536)])
def test_ln_matmul_bf16_route_holds_its_contract(cuda, R, D, F, vec_dtype):
    """B11's bf16 route (LN rows, then the TMA/wgmma GEMM) against
    ``ln_matmul_plain``, which is the TPU kernel's contract, within one
    output ulp: rows that are and are not a multiple of the GEMM's 128-row
    tile (the TMA zero fill and the store mask), the QA shape (2 clips x 16
    frames x 197), F = 896 and 384 (not multiples of 768, the old limit),
    D 64-1024, the layer's bf16 vectors read as they are or fp32 ones."""
    from alpro_tpu_torch.ops import ln_matmul

    s = (1 + _randn((D,), R, cuda, torch.float32, 0.1)).to(vec_dtype)
    b = _randn((D,), R + 1, cuda, torch.float32, 0.1).to(vec_dtype)
    w = _randn((F, D), R + 2, cuda, torch.bfloat16, D ** -0.5)
    bw = _randn((F,), R + 3, cuda, torch.float32, 0.02).to(vec_dtype)
    x = _randn((R, D), R + 4, cuda, torch.bfloat16, 2.0)
    n = ln_matmul.launches
    with torch.no_grad():
        got = ln_matmul.ln_matmul(x, s, b, w, bw, eps=1e-6)
    torch.cuda.synchronize()
    assert ln_matmul.launches == n + 1 and got.shape == (R, F) and got.dtype == torch.bfloat16
    want = ln_matmul.ln_matmul_plain(x, s, b, w, bw, 1e-6)
    torch.testing.assert_close(got.float(), want.float(), atol=ULP_ATOL, rtol=ULP_RTOL)


_MEAN, _STD = (0.48145466, 0.4578275, 0.40821073), (0.26862954, 0.26130258, 0.27577711)


def _frames(shape, seed, cuda):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, shape, generator=g, dtype=torch.uint8).to(cuda)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", [(8, 8, 224, 224, 3), (2, 16, 224, 224, 3),
                                   (1, 2, 232, 216, 3)])
def test_patchify_embed_kernel_matches_twin(cuda, shape, dtype):
    from alpro_tpu_torch.ops import preprocess

    raw = _frames(shape, 0, cuda)
    kernel = _randn((768, 768), 1, cuda, dtype, 768 ** -0.5)
    bias = _randn((768,), 2, cuda, dtype, 0.02)
    n = preprocess.launches
    got = preprocess.patchify_embed(raw, kernel, bias, _MEAN, _STD)
    torch.cuda.synchronize()
    assert preprocess.launches == n + 1
    assert got.shape == shape[:2] + ((shape[2] // 16) * (shape[3] // 16), 768)
    want = preprocess.patchify_embed_plain(raw, kernel, bias, _MEAN, _STD)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_patchify_embed_gradient_matches_twin_autograd(cuda):
    """fp32: the Function's backward (the JAX recompute from fp32 patches)
    against autograd through the twin, to summation order."""
    from alpro_tpu_torch.ops import preprocess

    raw = _frames((2, 8, 224, 224, 3), 3, cuda)
    k0 = _randn((768, 768), 4, cuda, torch.float32, 768 ** -0.5)
    b0 = _randn((768,), 5, cuda, torch.float32, 0.02)
    g = _randn((2, 8, 196, 768), 6, cuda, torch.float32)
    grads = []
    for fn in (preprocess.patchify_embed, preprocess.patchify_embed_plain):
        k, b = k0.clone().requires_grad_(True), b0.clone().requires_grad_(True)
        grads.append(torch.autograd.grad(fn(raw, k, b, _MEAN, _STD), (k, b), g))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-3, rtol=1e-4)


def _patchify_args(shape, p, D, cuda, seed, bias_dtype=torch.bfloat16):
    K = 3 * p * p
    return (_frames(shape, seed, cuda), _randn((K, D), seed + 1, cuda, torch.bfloat16, K ** -0.5),
            _randn((D,), seed + 2, cuda, torch.float32, 0.02).to(bias_dtype))


@pytest.mark.parametrize("bias_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,p,D", [((8, 8, 224, 224, 3), 16, 768),
                                       ((2, 16, 224, 224, 3), 16, 768),
                                       ((1, 2, 232, 216, 3), 16, 768),
                                       ((2, 4, 224, 224, 3), 8, 768),
                                       ((2, 4, 224, 224, 3), 16, 256),
                                       ((2, 4, 224, 224, 3), 16, 1024),
                                       ((1, 3, 40, 20, 3), 8, 384)])
def test_patchify_embed_bf16_route_holds_its_contract(cuda, shape, p, D, bias_dtype):
    """B15's bf16 route (the patch rows pass, then the TMA/wgmma GEMM over
    the (K, D) kernel in place) against the twin, which is the JAX
    function's contract, within one output ulp: the three shapes of the
    test above (W = 216: a frame row of 648 bytes, not a multiple of 16), p
    = 8 (K = 192), D 256, 1024 and 384 (not a row-tile width), frames not a
    multiple of p with rows of 60 bytes (byte loads), a bf16 or fp32 bias;
    one call adds one launch."""
    from alpro_tpu_torch.ops import preprocess

    raw, kernel, bias = _patchify_args(shape, p, D, cuda, seed=p + D, bias_dtype=bias_dtype)
    n = preprocess.launches
    with torch.no_grad():
        got = preprocess.patchify_embed(raw, kernel, bias, _MEAN, _STD)
    torch.cuda.synchronize()
    assert preprocess.launches == n + 1
    assert got.shape == shape[:2] + ((shape[2] // p) * (shape[3] // p), D)
    want = preprocess.patchify_embed_plain(raw, kernel, bias, _MEAN, _STD)
    torch.testing.assert_close(got.float(), want.float(), atol=ULP_ATOL, rtol=ULP_RTOL)


@pytest.mark.parametrize("shape,p,offset", [((2, 4, 224, 224, 3), 16, 0),
                                            ((1, 2, 232, 216, 3), 16, 0),
                                            ((2, 4, 224, 224, 3), 8, 0),
                                            ((2, 4, 224, 224, 3), 16, 1),
                                            ((1, 3, 40, 20, 3), 8, 0)])
def test_patchify_embed_rows_pass_is_patch_rows_plain(cuda, shape, p, offset):
    """The rows pass leaves ``patch_rows_plain`` in its scratch bit for bit
    (the same fp32 divisions, rounded once), computed on the CPU and on the
    card: 8-byte loads (W = 224 and 216) and byte loads (frames at an odd
    address, offset 1; W = 20, a frame row of 60 bytes)."""
    from alpro_tpu_torch.ops import preprocess

    buf = _frames((int(torch.tensor(shape).prod()) + offset,), 7, cuda)
    raw = buf[offset:].view(shape)
    _, kernel, bias = _patchify_args(shape, p, 256, cuda, seed=p)
    B, T, H, W, _ = shape
    rows = torch.empty(B * T * (H // p) * (W // p), 3 * p * p, device=cuda, dtype=torch.bfloat16)
    with torch.no_grad():
        preprocess._launch(raw, kernel, bias, 1, _MEAN, _STD, rows)
    torch.cuda.synchronize()
    for dev in ("cpu", cuda):
        want = preprocess.patch_rows_plain(raw.to(dev), p, _MEAN, _STD, torch.bfloat16)
        torch.testing.assert_close(rows.cpu(), want.cpu(), atol=0, rtol=0)


def test_patchify_embed_folded_route_misses_the_contract(cuda):
    """``PatchEmbed``'s fold (raw values · the kernel scaled by 1/(255 std),
    a bf16 product + the folded bias) rounds other values than the JAX
    function: on the same inputs it misses the one-ulp tolerance that the
    kernel holds, so the kernel test tells the two rounding points apart."""
    from alpro_tpu_torch.models.timesformer import PatchEmbed, TimeSformerConfig
    from alpro_tpu_torch.ops import preprocess

    raw, kernel, bias = _patchify_args((2, 8, 224, 224, 3), 16, 768, cuda, seed=11)
    pe = PatchEmbed(TimeSformerConfig()).to(cuda, torch.bfloat16)
    with torch.no_grad():
        pe.kernel.copy_(kernel)
        pe.bias.copy_(bias)
        got = preprocess.patchify_embed(raw, kernel, bias, _MEAN, _STD).float()
        fold = pe(preprocess._patches(raw, 16), torch.bfloat16, uint8_norm=True).float()
    want = preprocess.patchify_embed_plain(raw, kernel, bias, _MEAN, _STD).float()
    tol = ULP_ATOL + ULP_RTOL * want.abs()
    assert int(((got - want).abs() > tol).sum()) == 0
    assert int(((fold.reshape(want.shape) - want).abs() > tol).sum()) > 0
    assert 10 * float((got - want).abs().mean()) < float((fold.reshape(want.shape)
                                                          - want).abs().mean())


def test_patchify_embed_takes_a_bf16_bias_without_a_cast(cuda):
    """One call of the bf16 route with the model's bf16 bias launches the
    rows pass and the GEMM and no ``direct_copy`` (cast) kernel."""
    from alpro_tpu_torch.ops import preprocess

    raw, kernel, bias = _patchify_args((2, 4, 224, 224, 3), 16, 768, cuda, seed=5)
    with torch.no_grad():
        preprocess.patchify_embed(raw, kernel, bias, _MEAN, _STD)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            preprocess.patchify_embed(raw, kernel, bias, _MEAN, _STD)
            torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA and e.time_range.elapsed_us() > 0]
    assert not [n for n in names if "direct_copy" in n], names
    assert sum("patch_rows" in n for n in names) == 1, names
    assert sum("gemm_wgmma_kn" in n for n in names) == 1, names


def test_patchify_embed_limits_equal_the_kernel(cuda):
    """Past ``preprocess.fits`` the C side refuses too (an error code before
    any launch), and at it it launches: bf16 p 8 and 16 (K 192, 768), p 4
    and 12 (K 48, 432: not multiples of 64), D 128 and 1152, 192 and 200;
    frames of p and p - 1 pixels; fp32 D 768 and 896."""
    from alpro_tpu_torch.ops import preprocess

    bf = torch.bfloat16
    for p, D, H, W, dtype in ((8, 128, 8, 8, bf), (16, 1152, 16, 32, bf), (4, 128, 8, 8, bf),
                              (12, 128, 12, 12, bf), (8, 192, 8, 8, bf), (8, 200, 8, 8, bf),
                              (8, 128, 7, 8, bf), (8, 128, 8, 7, bf),
                              (16, 768, 16, 16, torch.float32), (16, 896, 16, 16, torch.float32)):
        raw = torch.zeros(1, 2, H, W, 3, device=cuda, dtype=torch.uint8)
        kernel = torch.zeros(3 * p * p, D, device=cuda, dtype=dtype)
        bias = torch.zeros(D, device=cuda, dtype=dtype)
        with torch.no_grad():
            if preprocess.fits(p, D, H, W, dtype):
                out = preprocess._launch(raw, kernel, bias, int(dtype == bf), _MEAN, _STD)
                assert out.shape == (1, 2, (H // p) * (W // p), D)
            else:
                with pytest.raises(RuntimeError, match="CUDA launch failed"):
                    preprocess._launch(raw, kernel, bias, int(dtype == bf), _MEAN, _STD)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,T", [(8, 8), (2, 16), (1, 32), (3, 5)])
def test_fused_temporal_block_kernel_matches_twin(cuda, B, T, dtype):
    from alpro_tpu_torch.ops import fused_block

    ws = _block_weights(cuda, dtype, seed=T)
    x = _randn((B, T, 196, 768), B + T, cuda, dtype)
    n = fused_block.temporal_launches
    got = fused_block.fused_temporal_block(x, *ws, 12, eps=1e-6)
    torch.cuda.synchronize()
    assert fused_block.temporal_launches == n + 1
    want = fused_block.fused_temporal_block_plain(x, *ws, 12, 1e-6)
    # bf16: the kernel stages q, k, v in bf16 (its TPU kernel's rounding
    # point), the twin keeps them in fp32
    tol = 3e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("vec_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,T", [(8, 8), (2, 16), (1, 32), (3, 5), (1, 48)])
def test_fused_temporal_block_holds_the_tpu_contract(cuda, B, T, vec_dtype):
    """B10's bf16 route against ``fused_temporal_block_reference`` (q, k and
    v rounded to bf16 after their fp32 bias, as the TPU kernel does) within
    one output ulp and 2^-7 (B10_ATOL): K2's fast path (T <= 32) and its
    wide path (T = 48), the layer's bf16 vectors read as they are or fp32
    ones."""
    ws = list(_block_weights(cuda, torch.bfloat16, seed=T))
    ws[:2] = [v.to(vec_dtype) for v in ws[:2]]
    ws[3], ws[5] = ws[3].to(vec_dtype), ws[5].to(vec_dtype)
    x = _randn((B, T, 196, 768), B + T, cuda, torch.bfloat16)
    n = fused_block.temporal_launches
    got = fused_block.fused_temporal_block(x, *ws, 12, eps=1e-6)
    torch.cuda.synchronize()
    assert fused_block.temporal_launches == n + 1
    want = fused_block.fused_temporal_block_reference(x, *ws, 12, 1e-6)
    torch.testing.assert_close(got.float(), want.float(), atol=B10_ATOL, rtol=B10_RTOL)


def test_fused_temporal_block_holds_the_contract_where_the_twin_misses(cuda):
    """q/k weights at std 4·D^-½ (scores in the tens). There the GEMM's fp32
    sums, in another order than torch's, flip the bf16 rounding of some q/k
    entries, each moving a score by ~1e-2 and a few outputs by up to ~3e-2:
    the kernel is held to the reference within 3e-2 (B10's tolerance
    against its twin), and, since those flips are rare where the twin
    (q, k and v in fp32) misses nearly everywhere, its mean miss is under a
    tenth of the twin's."""
    ws = list(_block_weights(cuda, torch.bfloat16, seed=7))
    ws[2] = ws[2] * torch.tensor([4.0] * 1536 + [1.0] * 768, device=cuda,
                                 dtype=torch.bfloat16)[:, None]
    x = _randn((8, 8, 196, 768), 8, cuda, torch.bfloat16)
    got = fused_block.fused_temporal_block(x, *ws, 12, eps=1e-6).float()
    want = fused_block.fused_temporal_block_reference(x, *ws, 12, 1e-6).float()
    twin = fused_block.fused_temporal_block_plain(x, *ws, 12, 1e-6).float()
    torch.testing.assert_close(got, want, atol=3e-2, rtol=3e-2)
    assert 10 * float((got - want).abs().mean()) < float((twin - want).abs().mean())


@pytest.mark.parametrize("T", [8, 48])
def test_fused_temporal_block_runs_b11_then_k2(cuda, T):
    """B10's bf16 route is B11's route, K2's body and the projection: the
    packed qkv it leaves in its scratch is ``ln_matmul``'s output bit for
    bit, and the heads are K2's (``temporal_attention_qkv``, csrc/
    temporal_attn.cu's instantiation of the shared body) on that qkv bit for
    bit, on K2's fast path (T = 8) and its wide path (T = 48)."""
    from alpro_tpu_torch.ops import ln_matmul

    B, N, D, H = 2, 196, 768, 12
    ws = [t.to(torch.bfloat16) for t in _block_weights(cuda, torch.bfloat16, seed=T)]
    x = _randn((B, T, N, D), T, cuda, torch.bfloat16)
    scratch = torch.empty(fused_block.temporal_scratch_shape(B, T, N, D, x.dtype),
                          dtype=x.dtype, device=cuda)
    vecs = (ws[0], ws[1], ws[3], ws[5])
    with torch.no_grad():
        fused_block._launch_temporal(x, vecs, 1, ws[2], ws[4], H, 1e-6, scratch)
        heads = scratch[0].reshape(B, T, N, D).clone()
        qkv = scratch[1:].reshape(B, T, N, 3 * D)
        torch.testing.assert_close(qkv, ln_matmul.ln_matmul(x, ws[0], ws[1], ws[2], ws[3],
                                                            eps=1e-6), atol=0, rtol=0)
        torch.testing.assert_close(heads, qkv_attn.temporal_attention_qkv(qkv, H), atol=0,
                                   rtol=0)


def test_temporal_block_and_ln_matmul_limits_equal_the_kernels(cuda):
    """Past ``temporal_fits`` and ``ln_matmul.fits`` the C side refuses too
    (an error code before any launch), and at them it launches: bf16 T 128
    and 129, head_dim 128 and 136, D 1024 and 1152, 640 (not a multiple of
    the GEMM's 128 columns); B11 F 128 and 192, D 64 and 96."""
    from alpro_tpu_torch.ops import ln_matmul

    bf, smem = torch.bfloat16, _build.smem_optin(cuda)
    for T, D, H in ((128, 768, 12), (129, 768, 12), (8, 1024, 8), (8, 1088, 8), (8, 1152, 9),
                    (8, 640, 10), (8, 768, 6)):
        x = torch.zeros(1, T, 2, D, device=cuda, dtype=bf)
        w = (torch.zeros(3 * D, D, device=cuda, dtype=bf), torch.zeros(D, D, device=cuda,
                                                                         dtype=bf))
        vecs = tuple(torch.zeros(n, device=cuda, dtype=bf) for n in (D, D, 3 * D, D))
        fits = fused_block.temporal_fits(1, T, D, H, bf, smem)
        if fits:
            fused_block._launch_temporal(x, vecs, 1, *w, H, 1e-6)
        else:
            with pytest.raises(RuntimeError, match="CUDA launch failed"):
                fused_block._launch_temporal(x, vecs, 1, *w, H, 1e-6)
    torch.cuda.synchronize()
    for D, F in ((64, 128), (96, 128), (768, 192), (768, 128)):
        x, w = torch.zeros(5, D, device=cuda, dtype=bf), torch.zeros(F, D, device=cuda, dtype=bf)
        vecs = tuple(torch.zeros(n, device=cuda, dtype=bf) for n in (D, D, F))
        if ln_matmul.fits(D, F, bf):
            ln_matmul._launch(x, vecs, 1, w, 1e-6)
        else:
            with pytest.raises(RuntimeError, match="CUDA launch failed"):
                ln_matmul._launch(x, vecs, 1, w, 1e-6)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,S,residual", [(64, 197, False), (32, 197, True), (3, 17, False),
                                          (2, 256, True), (4, 257, False), (2, 577, True),
                                          (1, 2048, False)])
def test_fused_spatial_block_kernel_matches_twin(cuda, M, S, residual, dtype):
    """Up to 256 keys one chunk; 257 (256² frames) and 577 (384²) stream
    their keys in chunks, and 2048 is far past them (bf16 has no S limit);
    fp32 runs those at its own limit, 256."""
    from alpro_tpu_torch.ops import fused_block

    if dtype == torch.float32:
        S = min(S, fused_block.spatial_max_seq_len(dtype, cuda))
    ws = _block_weights(cuda, dtype, seed=S)
    x = _randn((M, S, 768), M + S, cuda, dtype)
    n = fused_block.spatial_launches
    got = fused_block.fused_spatial_block(x, *ws, 12, eps=1e-6, residual=residual)
    torch.cuda.synchronize()
    assert fused_block.spatial_launches == n + 1
    want = fused_block.fused_spatial_block_plain(x, *ws, 12, 1e-6, residual)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_fused_ingest_kernels_refuse_grad_and_limits(cuda):
    """B9, B10 and B11 have no backward: under grad with an input that
    requires grad they raise; past their limits (S, T) they raise naming
    them."""
    from alpro_tpu_torch.ops import fused_block, ln_matmul

    ws = _block_weights(cuda, torch.float32)
    x = _randn((2, 4, 196, 768), 0, cuda, torch.float32).requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        fused_block.fused_temporal_block(x, *ws, 12, eps=1e-6)
    with pytest.raises(RuntimeError, match="no backward"):
        fused_block.fused_spatial_block(x[0], *ws, 12, eps=1e-6)
    with pytest.raises(RuntimeError, match="no backward"):
        ln_matmul.ln_matmul(x, *ws[:4], eps=1e-6)
    with torch.no_grad():
        assert fused_block.fused_spatial_block(x[0], *ws, 12, eps=1e-6).shape == (4, 196, 768)
        # bf16: no S limit (the keys stream past 256), S = 577 and far past launch;
        # fp32 keeps its 256: one past raises before a launch
        assert fused_block.spatial_max_seq_len(torch.bfloat16, cuda) is None
        wb = _block_weights(cuda, torch.bfloat16)
        for S in (577, 4096):
            got = fused_block.fused_spatial_block(torch.zeros(1, S, 768, device=cuda,
                                                              dtype=torch.bfloat16), *wb, 12,
                                                  eps=1e-6)
            assert got.shape == (1, S, 768) and bool(torch.isfinite(got).all())
        limit = fused_block.spatial_max_seq_len(torch.float32, cuda)
        assert limit == 256
        n = fused_block.spatial_launches
        with pytest.raises(ValueError, match=f"S <= {limit}"):
            fused_block.fused_spatial_block(torch.zeros(1, limit + 1, 768, device=cuda), *ws, 12,
                                            eps=1e-6)
        assert fused_block.spatial_launches == n
        with pytest.raises(ValueError, match="T <= 32"):
            fused_block.fused_temporal_block(torch.zeros(1, 33, 2, 768, device=cuda), *ws, 12,
                                             eps=1e-6)
        # bf16: K2's T <= 128 (T = 33 and 128 launch), one past raises before a launch
        n = fused_block.temporal_launches
        for T in (33, 128):
            got = fused_block.fused_temporal_block(torch.zeros(1, T, 2, 768, device=cuda,
                                                               dtype=torch.bfloat16), *wb, 12,
                                                   eps=1e-6)
            assert got.shape == (1, T, 2, 768) and bool(torch.isfinite(got).all())
        with pytest.raises(ValueError, match="1 <= T <= 128"):
            fused_block.fused_temporal_block(torch.zeros(1, 129, 2, 768, device=cuda,
                                                         dtype=torch.bfloat16), *wb, 12, eps=1e-6)
        assert fused_block.temporal_launches == n + 2


def _spatial_block_rounded_qk(x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, H, eps):
    """B9's twin with q and k rounded to bf16 after their fp32 bias (what a
    kernel that kept them in bf16 would compute)."""
    M, S, D = x.shape
    hd = D // H
    qkv = fused_block._lin_f32(ln_rows_f32(x, ln_s, ln_b, eps), wqkv, bqkv)
    q, k, v = (qkv[..., i * D:(i + 1) * D].reshape(M, S, H, hd) for i in range(3))
    q, k = (t.to(torch.bfloat16).float() for t in (q, k))
    p = torch.softmax(torch.einsum("mqhd,mkhd->mhqk", q, k) * hd ** -0.5, dim=-1)
    o = torch.einsum("mhqk,mkhd->mqhd", p, v).reshape(M, S, D)
    return fused_block._lin_f32(o, wproj, bproj).to(x.dtype)


def test_fused_spatial_block_keeps_q_k_v_and_p_unrounded(cuda):
    """Scores in the tens (the q and k weights at std 4·D^-½, scores' std
    ~16): the bf16 kernel, which carries q, k, v and p as hi + lo pairs,
    stays within atol = rtol = 2e-2 of the twin (fp32 q, k, v, scores and p:
    the TPU kernel's contract), where the same twin with q and k rounded to
    bf16 misses it (~0.1 off at its worst). A kernel that rounds q or k
    fails here."""
    M, S, D, H = 8, 197, 768, 12
    bf = torch.bfloat16
    ln_s, ln_b, _, bqkv, wproj, bproj = _block_weights(cuda, bf, seed=60)
    wqkv = torch.cat([_randn((2 * D, D), 61, cuda, torch.float32, 4 * D ** -0.5),
                      _randn((D, D), 62, cuda, torch.float32, D ** -0.5)]).to(bf)
    x = _randn((M, S, D), 63, cuda, bf)
    args = (x, ln_s, ln_b, wqkv, bqkv, wproj, bproj, H)
    got = fused_block.fused_spatial_block(*args, eps=1e-6).float()
    twin = fused_block.fused_spatial_block_plain(*args, 1e-6).float()
    rounded = _spatial_block_rounded_qk(*args, 1e-6).float()
    torch.testing.assert_close(got, twin, atol=2e-2, rtol=2e-2)
    assert int(((rounded - twin).abs() > 2e-2 + 2e-2 * twin.abs()).sum()) > 0


def test_fused_spatial_kernels_read_bf16_vectors_as_fp32(cuda):
    """The layer's bf16 LN and bias vectors, read as they are, give what
    their fp32 copies give, bit for bit (widening bf16 is exact): B9 with
    and without the residual, B7."""
    bf = torch.bfloat16
    ln_s, ln_b, wqkv, bqkv, wproj, bproj = _block_weights(cuda, bf, seed=70)
    vecs = [t.to(bf) for t in (ln_s, ln_b, bqkv, bproj)]
    x = _randn((16, 197, 768), 71, cuda, bf)
    for residual in (False, True):
        a = fused_block.fused_spatial_block(x, vecs[0], vecs[1], wqkv, vecs[2], wproj, vecs[3],
                                            12, eps=1e-6, residual=residual)
        b = fused_block.fused_spatial_block(x, *(vecs[i].float() for i in (0, 1)), wqkv,
                                            vecs[2].float(), wproj, vecs[3].float(), 12,
                                            eps=1e-6, residual=residual)
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    qkv = _randn((16, 197, 3 * 768), 72, cuda, bf)
    torch.testing.assert_close(qkv_attn.spatial_attention_qkv_proj(qkv, wproj, vecs[3], 12),
                               qkv_attn.spatial_attention_qkv_proj(qkv, wproj, vecs[3].float(),
                                                                   12), atol=0, rtol=0)


# ---- the opt-in serving forms B6, B7, B8 and the LayerNorm kernel B14 ------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,T,N", [(8, 8, 196), (2, 16, 196), (1, 3, 17)])
def test_spatial_cls_kernel_matches_twin(cuda, B, T, N, dtype):
    H, hd = 12, 64
    qx = _randn((B * T, N, 3 * H * hd), N + T, cuda, dtype)
    qc = _randn((B, 1, 3 * H * hd), B, cuda, dtype)
    n = qkv_attn.spatial_cls_launches
    got = qkv_attn.spatial_attention_qkv_cls(qx, qc, H, T)
    torch.cuda.synchronize()
    assert qkv_attn.spatial_cls_launches == n + 1
    want = qkv_attn.spatial_attention_qkv_cls_plain(qx, qc, H, hd ** -0.5, T)
    tol = 3e-2 if dtype == torch.bfloat16 else 1e-5
    for a, b in zip(got, want):
        torch.testing.assert_close(a.float(), b.float(), atol=tol, rtol=tol)


def _proj_weights(D, cuda, dtype, seed):
    return (_randn((D, D), seed, cuda, dtype, D ** -0.5),
            _randn((D,), seed + 1, cuda, torch.float32, 0.02))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,S", [(64, 197), (32, 197), (3, 17), (2, 256), (4, 257), (2, 577),
                                 (1, 2048)])
def test_spatial_qkv_proj_kernel_matches_twin(cuda, M, S, dtype):
    """As B9's: one key chunk up to 256, streamed past it, no bf16 S limit;
    fp32 at its own 256."""
    if dtype == torch.float32:
        S = min(S, qkv_attn.spatial_max_seq_len(dtype, cuda))
    x = _randn((M, S, 3 * 768), S + M, cuda, dtype)
    w, b = _proj_weights(768, cuda, dtype, S)
    n = qkv_attn.spatial_proj_launches
    got = qkv_attn.spatial_attention_qkv_proj(x, w, b, 12)
    torch.cuda.synchronize()
    assert qkv_attn.spatial_proj_launches == n + 1
    want = qkv_attn.spatial_attention_qkv_proj_plain(x, w, b, 12, 0.125)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


_B8_CASES = [(B, T, dtype, torch.float32) for dtype in (torch.bfloat16, torch.float32)
             for B, T in ((8, 8), (2, 16), (1, 32), (3, 5))] + [
    (B, T, torch.bfloat16, torch.bfloat16) for B, T in ((8, 8), (2, 16), (1, 32), (3, 5),
                                                        (1, 48), (1, 128))]


@pytest.mark.parametrize("B,T,dtype,bias_dtype", _B8_CASES)
def test_temporal_qkv_proj_kernel_matches_twin(cuda, B, T, dtype, bias_dtype):
    """B8 against its twin: bf16 within 2e-2, fp32 within 1e-4; in bf16
    (K2's body into the heads scratch, then the GEMM's kRound) with b_eff
    fp32 or bf16 (as the bf16 model passes it), on K2's fast path up to T =
    32 and its wide path at T = 48 and 128, past the fp32 route's 32."""
    x = _randn((B, T, 196, 3 * 768), B + T, cuda, dtype)
    w, b = _proj_weights(768, cuda, dtype, T)
    b = b.to(bias_dtype)
    n = qkv_attn.temporal_proj_launches
    got = qkv_attn.temporal_attention_qkv_proj(x, w, b, 12)
    torch.cuda.synchronize()
    assert qkv_attn.temporal_proj_launches == n + 1
    want = qkv_attn.temporal_attention_qkv_proj_plain(x, w, b, 12, 0.125)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("qk_scale", [1.0, 4.0])
def test_temporal_qkv_proj_rounds_the_heads_once(cuda, qk_scale):
    """The TPU kernel rounds the per-head output to w_eff's dtype before the
    projection (``opart.astype(we_ref.dtype)``), as the twin does. Against
    the twin the kernel misses only where fp32 sums in another order flip a
    rounding; a route that kept the per-head output in fp32 into the
    product misses nearly everywhere, by 10x the kernel's mean miss or more;
    at q and k scaled by 4 (scores in the tens) too."""
    x = _randn((8, 8, 196, 3 * 768), 11, cuda, torch.bfloat16)
    x[..., :2 * 768] *= qk_scale
    w, b = _proj_weights(768, cuda, torch.bfloat16, 12)
    b = b.to(torch.bfloat16)
    got = qkv_attn.temporal_attention_qkv_proj(x, w, b, 12).float()
    twin = qkv_attn.temporal_attention_qkv_proj_plain(x, w, b, 12, 0.125).float()
    o = qkv_attn.temporal_attention_plain(x.float(), 12, 0.125)  # never rounded
    unrounded = (o @ w.float().t() + b.float()).to(torch.bfloat16).float()
    kernel_miss = float((got - twin).abs().mean())
    assert 10 * kernel_miss < float((unrounded - twin).abs().mean())


@pytest.mark.parametrize("T", [8, 48])
def test_temporal_qkv_proj_runs_k2_then_the_gemm(cuda, T):
    """B8's bf16 route leaves K2's output in its heads scratch: bit for bit
    what ``temporal_attention_qkv`` (csrc/temporal_attn.cu's instantiation of
    the shared body) gives on the same qkv, on K2's fast path (T = 8) and
    its wide path (T = 48)."""
    B, N, D, H = 2, 196, 768, 12
    x = _randn((B, T, N, 3 * D), T, cuda, torch.bfloat16)
    w, b = _proj_weights(D, cuda, torch.bfloat16, T)
    heads = torch.empty(B, T, N, D, device=cuda, dtype=torch.bfloat16)
    with torch.no_grad():
        qkv_attn._launch_temporal_proj(x, w, b.to(torch.bfloat16), 1, H, 0.125, heads)
        torch.testing.assert_close(heads, qkv_attn.temporal_attention_qkv(x, H), atol=0, rtol=0)


def test_temporal_qkv_proj_limits_equal_the_kernel(cuda):
    """Past ``temporal_proj_fits`` the C side refuses too (an error code
    before any launch), and at it it launches: bf16 T 128 and 129, head_dim
    128 and 136, D 1024 and 576 (not a multiple of the GEMM's 128
    columns), head_dim 32 at D 768; fp32 T 32 and 33, head_dim 32."""
    smem = _build.smem_optin(cuda)
    for dtype, T, D, H in ((torch.bfloat16, 128, 768, 12), (torch.bfloat16, 129, 768, 12),
                           (torch.bfloat16, 8, 1024, 8), (torch.bfloat16, 8, 1088, 8),
                           (torch.bfloat16, 8, 576, 9), (torch.bfloat16, 8, 768, 24),
                           (torch.float32, 32, 768, 12), (torch.float32, 33, 768, 12),
                           (torch.float32, 8, 768, 24)):
        x = torch.zeros(1, T, 2, 3 * D, device=cuda, dtype=dtype)
        w, b = torch.zeros(D, D, device=cuda, dtype=dtype), torch.zeros(D, device=cuda)
        fits = qkv_attn.temporal_proj_fits(1, T, D, H, dtype, smem)
        with torch.no_grad():
            if fits:
                qkv_attn._launch_temporal_proj(x, w, b, 0, H, 0.125)
            else:
                with pytest.raises(RuntimeError, match="CUDA launch failed"):
                    qkv_attn._launch_temporal_proj(x, w, b, 0, H, 0.125)
    torch.cuda.synchronize()


def test_opt_in_serving_kernels_refuse_grad_and_limits(cuda):
    """B6, B7 and B8 have no backward: under grad with an input that
    requires grad they raise; under no_grad they run; past their limits (S,
    T) they raise naming them."""
    x = _randn((4, 17, 3 * 768), 0, cuda, torch.float32).requires_grad_(True)
    c = _randn((2, 1, 3 * 768), 1, cuda, torch.float32)
    w, b = _proj_weights(768, cuda, torch.float32, 2)
    with pytest.raises(RuntimeError, match="no backward"):
        qkv_attn.spatial_attention_qkv_cls(x, c, 12, 2)
    with pytest.raises(RuntimeError, match="no backward"):
        qkv_attn.spatial_attention_qkv_proj(x, w, b, 12)
    with pytest.raises(RuntimeError, match="no backward"):
        qkv_attn.temporal_attention_qkv_proj(x[None], w, b, 12)
    with torch.no_grad():
        assert qkv_attn.spatial_attention_qkv_cls(x, c, 12, 2)[1].shape == (4, 1, 768)
        # bf16: no S limit (K1's plan streams past 256 keys); fp32 keeps 256
        assert qkv_attn.spatial_max_seq_len(torch.bfloat16, cuda) is None
        wb = w.to(torch.bfloat16)
        for S in (577, 4096):
            got = qkv_attn.spatial_attention_qkv_proj(
                torch.zeros(1, S, 3 * 768, device=cuda, dtype=torch.bfloat16), wb, b, 12)
            assert got.shape == (1, S, 768) and bool(torch.isfinite(got).all())
        limit = qkv_attn.spatial_max_seq_len(torch.float32, cuda)
        assert limit == 256
        n = qkv_attn.spatial_proj_launches
        with pytest.raises(ValueError, match=f"S <= {limit}"):
            qkv_attn.spatial_attention_qkv_proj(torch.zeros(1, limit + 1, 3 * 768, device=cuda),
                                                w, b, 12)
        assert qkv_attn.spatial_proj_launches == n
        with pytest.raises(ValueError, match="T <= 32"):
            qkv_attn.temporal_attention_qkv_proj(torch.zeros(1, 33, 2, 3 * 768, device=cuda),
                                                 w, b, 12)
        # bf16: K2's T <= 128 and the GEMM's D % 128, raised before a launch
        n = qkv_attn.temporal_proj_launches
        with pytest.raises(ValueError, match="1 <= T <= 128"):
            qkv_attn.temporal_attention_qkv_proj(
                torch.zeros(1, 129, 2, 3 * 768, device=cuda, dtype=torch.bfloat16), wb, b, 12)
        with pytest.raises(ValueError, match="D a multiple of 128"):
            qkv_attn.temporal_attention_qkv_proj(
                torch.zeros(1, 8, 2, 3 * 576, device=cuda, dtype=torch.bfloat16),
                torch.zeros(576, 576, device=cuda, dtype=torch.bfloat16),
                torch.zeros(576, device=cuda), 9)
        assert qkv_attn.temporal_proj_launches == n


@pytest.mark.parametrize("in_dtype,out_dtype", [(torch.bfloat16, torch.bfloat16),
                                                (torch.float32, torch.bfloat16),
                                                (torch.bfloat16, torch.float32),
                                                (torch.float32, torch.float32)])
@pytest.mark.parametrize("R,D", [(12608, 768), (5, 32), (7, 2048), (3, 1000)])
def test_layernorm_kernel_matches_twin(cuda, R, D, in_dtype, out_dtype):
    from alpro_tpu_torch.ops import layernorm

    x = _randn((R, D), R, cuda, in_dtype, 2.0) + 1
    s, b = 1 + _randn((D,), 1, cuda, torch.float32, 0.1), _randn((D,), 2, cuda, torch.float32, 0.1)
    n = layernorm.launches
    got = layernorm.layernorm(x, s, b, eps=1e-6, out_dtype=out_dtype)
    torch.cuda.synchronize()
    assert layernorm.launches == n + 1 and got.dtype == out_dtype
    want = layernorm.layernorm_plain(x, s, b, 1e-6, out_dtype)
    tol = 2e-2 if out_dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_layernorm_gradient_matches_twin_autograd(cuda):
    """``LayerNorm(impl='pallas')``: the kernel forward (one launch) and the
    Function's backward (JAX's analytic _bwd) against autograd through the
    twin, fp32 to rounding; bf16 in, bf16 out runs and is finite."""
    from alpro_tpu_torch.ops import layernorm
    from alpro_tpu_torch.ops.layers import LayerNorm

    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, None)):
        mod = LayerNorm(768, 1e-6, impl="pallas").to(cuda)
        x = _randn((3, 40, 768), 3, cuda, dtype, 2.0).requires_grad_(True)
        n = layernorm.launches
        out = mod(x, dtype)
        g = _randn(out.shape, 4, cuda, dtype)
        got = torch.autograd.grad(out, (x, mod.weight, mod.bias), g)
        assert layernorm.launches == n + 1
        assert all(bool(torch.isfinite(t).all()) for t in got)
        if tol is None:
            continue
        ref = x.detach().clone().requires_grad_(True)
        s, b = (p.detach().clone().requires_grad_(True) for p in (mod.weight, mod.bias))
        want = torch.autograd.grad(layernorm.layernorm_plain(ref, s, b, 1e-6, dtype), (ref, s, b),
                                   g)
        for a, w in zip(got, want):
            torch.testing.assert_close(a, w, atol=tol, rtol=tol)
    with pytest.raises(ValueError, match="D <= 2048"):
        layernorm.layernorm(torch.zeros(2, 2056, device=cuda), torch.ones(2056, device=cuda),
                            torch.zeros(2056, device=cuda), eps=1e-6)


# ---- B16: the temporal kernel's whole envelope; K1's S limit ----


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd,T", [(8, 3), (16, 4), (40, 7), (24, 100), (64, 48), (64, 128),
                                  (96, 33), (128, 64), (64, 8)])
def test_temporal_roll_kernel_envelope_matches_twin(cuda, hd, T, dtype):
    B, N, H = 2, 9, 3
    x = _randn((B, T, N, 3 * H * hd), T + hd, cuda, dtype)
    n = temporal_attn.roll_launches
    got = temporal_attn.temporal_attention_roll(x, H)
    torch.cuda.synchronize()
    assert temporal_attn.roll_launches == n + 1
    want = temporal_attn.temporal_attention_roll_plain(x, H)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


_FAST_EDGES = [(hd, T) for hd in (8, 32, 40, 64, 96, 128) for T in (1, 2, 8, 9, 16, 17, 32)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd,T", _FAST_EDGES)
def test_temporal_fast_path_edges_match_twin(cuda, hd, T, dtype):
    """K2's fast path (T <= 32, every head_dim a multiple of 8 up to 128)
    at its edges: T 1, 2, one tile's frames (8, 16, 32) and one past (9,
    17), head_dim 8 to 128 (one 16-byte chunk to sixteen, and 40 and 96,
    whose rows are no power of two), H = 3 (tiles of 3 heads), N = 11 (a
    ragged last tile of locations); K2 and B16 (one body) against their
    twins, K2's tolerance."""
    B, N, H = 2, 11, 3
    x = _randn((B, T, N, 3 * H * hd), T + hd, cuda, dtype)
    tol = 1e-2 if dtype == torch.bfloat16 else 1e-5
    want = qkv_attn.temporal_attention_plain(x, H, hd ** -0.5).float()
    n, nr = qkv_attn.temporal_launches, temporal_attn.roll_launches
    torch.testing.assert_close(qkv_attn.temporal_attention_qkv(x, H).float(), want, atol=tol,
                               rtol=tol)
    torch.testing.assert_close(temporal_attn.temporal_attention_roll(x, H).float(), want,
                               atol=tol, rtol=tol)
    assert (qkv_attn.temporal_launches, temporal_attn.roll_launches) == (n + 1, nr + 1)


def test_temporal_roll_gradient_matches_twin_autograd(cuda):
    x = _randn((2, 40, 5, 3 * 2 * 40), 7, cuda, torch.float32)
    cot = _randn((2, 40, 5, 2 * 40), 8, cuda, torch.float32)
    a = x.clone().requires_grad_(True)
    (got,) = torch.autograd.grad(temporal_attn.temporal_attention_roll(a, 2), a, cot)
    b = x.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(temporal_attn.temporal_attention_roll_plain(b, 2), b, cot)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_spatial_kernel_raises_past_its_seq_limit(cuda):
    """K1 has no limit on S since it walks long rows in key chunks: S = 257
    (256² frames, past the former limit of 224) and 640 launch and match the twin. Its
    limit is the head_dim: one past the envelope (48, a multiple of 16 but
    no kernel's panel width) K1 and B6 raise ValueError before a launch."""
    for S in (257, 640):
        x = _randn((2, S, 3 * 768), S, cuda, torch.bfloat16)
        torch.testing.assert_close(qkv_attn.spatial_attention_qkv(x, 12).float(),
                                   qkv_attn.spatial_attention_plain(x, 12, 0.125).float(),
                                   atol=3e-2, rtol=3e-2)
    n, nc = qkv_attn.spatial_launches, qkv_attn.spatial_cls_launches
    x = torch.zeros(2, 197, 3 * 16 * 48, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim in"):
        qkv_attn.spatial_attention_qkv(x, 16)
    with pytest.raises(ValueError, match="head_dim in"):
        qkv_attn.spatial_attention_qkv_cls(x[:, :196].contiguous(), x[:1, :1].contiguous(), 16, 2)
    assert (qkv_attn.spatial_launches, qkv_attn.spatial_cls_launches) == (n, nc)


def test_python_limits_equal_the_kernels(cuda):
    smem = _build.smem_optin(cuda)
    lib, dev = _build.lib(), torch.cuda.current_device()
    for dtype in (torch.bfloat16, torch.float32):
        bf = int(dtype == torch.bfloat16)
        assert bert_block.max_seq(dtype, smem) == lib.alpro_bert_attn_max_seq(bf, dev)
        assert block_attn.max_seq(dtype, smem) == lib.alpro_block_attn_max_seq(bf, dev)
        for hd in (16, 32, 48, 64, 128):
            for S in (1, 64, 65, 197, 256, 257, 577, 640, 709, 769, 1000, 4000, 20480, 20481):
                assert qkv_attn.spatial_smem_bytes(S, hd, dtype, smem) == \
                    qkv_attn.spatial_launch_smem(S, hd, dtype, cuda), (S, hd, dtype)
                assert masked_attn.smem_bytes(S, hd, dtype, smem) == \
                    lib.alpro_masked_attn_smem(S, hd, bf, dev), ("masked", S, hd, dtype)
        for T in (1, 5, 8, 16, 17, 32, 33, 48, 128, 129):
            for hd in (0, 8, 36, 40, 64, 96, 128, 136):
                assert qkv_attn.temporal_smem_bytes(T, hd, dtype, smem) == \
                    qkv_attn.temporal_launch_smem(T, hd, dtype, cuda), ("temporal", T, hd, dtype)
        for S in (1, 17, 150, 197, 208, 256, 257, 577, 4000, 20481):
            assert fused_block.spatial_smem(S, dtype, smem) == \
                lib.alpro_fused_spatial_smem(S, bf, dev), ("fused_block", S, dtype)
            assert qkv_attn.spatial_proj_smem(S, dtype, smem) == \
                lib.alpro_spatial_qkv_proj_smem(S, bf, dev), ("qkv_proj", S, dtype)


# ---- B17: the whole attention sublayer ----


def _block_args(B, S, D, cuda, dtype, seed=0):
    return (_randn((B, S, D), seed, cuda, dtype),
            _randn((3 * D, D), seed + 1, cuda, dtype, D ** -0.5),
            _randn((3 * D,), seed + 2, cuda, torch.float32, 0.1),
            _randn((D, D), seed + 3, cuda, dtype, D ** -0.5),
            _randn((D,), seed + 4, cuda, torch.float32, 0.1))


def _lengths_mask(B, S, cuda):
    mask = torch.ones(B, S, device=cuda)
    for b in range(B):
        mask[b, 1 + (37 * b) % S:] = 0.0
    return mask


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,S,D,masked", [(4, 197, 768, False), (4, 197, 768, True),
                                          (3, 17, 256, True), (2, 150, 1024, False),
                                          (2, 256, 512, True), (2, 577, 768, True),
                                          (1, 1000, 768, False)])
def test_block_attn_kernel_matches_twin(cuda, B, S, D, masked, dtype):
    if dtype == torch.float32 and S > block_attn.max_seq(dtype, _build.smem_optin(cuda)):
        S = block_attn.max_seq(dtype, _build.smem_optin(cuda))
    args = _block_args(B, S, D, cuda, dtype, seed=S)
    mask = _lengths_mask(B, S, cuda) if masked else None
    H = D // 64
    n = block_attn.launches
    got = block_attn.fused_attention_block(*args, H, mask)
    torch.cuda.synchronize()
    assert block_attn.launches == n + 1
    want = block_attn.fused_attention_block_plain(*args, H, mask)
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def test_block_attn_gradients_match_twin_autograd(cuda):
    """The Function's backward is the twin's vjp: all five gradients equal
    autograd through the twin on the same inputs (fp32, up to the
    recompute's summation order)."""
    args = _block_args(2, 33, 256, cuda, torch.float32, seed=5)
    mask = _lengths_mask(2, 33, cuda)
    cot = _randn((2, 33, 256), 11, cuda, torch.float32)
    a = [t.clone().requires_grad_(True) for t in args]
    got = torch.autograd.grad(block_attn.fused_attention_block(*a, 4, mask), a, cot)
    b = [t.clone().requires_grad_(True) for t in args]
    want = torch.autograd.grad(block_attn.fused_attention_block_plain(*b, 4, mask), b, cot)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)


def test_block_attn_raises_past_its_limits(cuda):
    limit = block_attn.max_seq(torch.bfloat16, _build.smem_optin(cuda))
    args = _block_args(1, limit, 768, cuda, torch.bfloat16)
    got = block_attn.fused_attention_block(*args, 12)
    torch.testing.assert_close(got.float(),
                               block_attn.fused_attention_block_plain(*args, 12).float(),
                               atol=2e-2, rtol=2e-2)
    with pytest.raises(ValueError, match=f"S <= {limit}"):
        block_attn.fused_attention_block(*_block_args(1, limit + 1, 768, cuda, torch.bfloat16),
                                         12)
    with pytest.raises(ValueError, match="head_dim 64"):
        block_attn.fused_attention_block(*_block_args(1, 9, 768, cuda, torch.bfloat16), 16)


def test_block_attn_keeps_q_and_k_unrounded(cuda):
    """Scores in the tens (q and k weights 0.25, scores' std ~50): the kernel
    holds to the TPU kernel's contract (q and k in fp32) at 2e-2, where the
    twin, which rounds q and k to bf16, misses the same reference by at
    least five times that. A kernel that rounds q or k fails here."""
    B, S, D, H = 4, 197, 768, 12
    x = _randn((B, S, D), 40, cuda, torch.bfloat16)
    wqkv = torch.cat([_randn((2 * D, D), 41, cuda, torch.float32, 0.25),
                      _randn((D, D), 42, cuda, torch.float32, D ** -0.5)]).to(torch.bfloat16)
    rest = (_randn((3 * D,), 43, cuda, torch.float32, 0.1),
            _randn((D, D), 44, cuda, torch.bfloat16, D ** -0.5),
            _randn((D,), 45, cuda, torch.float32, 0.1))
    for mask in (None, _lengths_mask(B, S, cuda)):
        args = (x, wqkv, *rest, H, mask)
        got = block_attn.fused_attention_block(*args)
        ref = block_attn.fused_attention_block_reference(*args)
        twin = block_attn.fused_attention_block_plain(*args)
        torch.testing.assert_close(got.float(), ref.float(), atol=2e-2, rtol=2e-2)
        assert float((twin.float() - ref.float()).abs().max()) >= 5 * 2e-2


@pytest.mark.parametrize("M,N,K,split", [(12608, 2304, 768, 768), (12608, 768, 768, 0),
                                         (12608, 2304, 768, 0), (1000, 3072, 1024, 1024),
                                         (77, 768, 768, 0), (9, 768, 256, 256),
                                         (300, 512, 512, 0)])
def test_gemm_bf16_matches_fp32_product(cuda, M, N, K, split):
    """B17's GEMM at its qkv (split) and projection shapes (one add_videos
    call's 12608 rows) and at row counts that are no multiple of the 128-row
    tile: y = a·wᵀ + bias in fp32 from the upcast operands, rounded once
    (bf16: half an ulp, 2^-9 of |y|, plus the fp32 sums' order), or split
    into hi + lo (within 2^-15 of |y|, plus the sums' order) and v."""
    a = _randn((M, K), M + N, cuda, torch.bfloat16)
    w = _randn((N, K), K, cuda, torch.bfloat16, K ** -0.5)
    bias = _randn((N,), 3, cuda, torch.float32, 0.1)
    y = a.float() @ w.float().t() + bias
    got = block_attn.gemm_bf16(a, w, bias, split)
    torch.cuda.synchronize()
    if not split:
        torch.testing.assert_close(got.float(), y, atol=1e-4, rtol=2 ** -8)
        return
    D = split
    for i, part in enumerate(y.split(D, dim=1)[:2]):
        hi, lo = got[2 * i].float(), got[2 * i + 1].float()
        torch.testing.assert_close(hi, part, atol=1e-4, rtol=2 ** -8)
        torch.testing.assert_close(hi + lo, part, atol=1e-4, rtol=2 ** -15)
    torch.testing.assert_close(got[4].float(), y[:, 2 * D:], atol=1e-4, rtol=2 ** -8)


def _stream_cases(cuda):
    from alpro_tpu_torch.ops import layernorm, ln_matmul, preprocess

    x = _randn((12608, 768), 50, cuda, torch.bfloat16, 2.0)
    s, b = 1 + _randn((768,), 51, cuda, torch.float32, 0.1), _randn((768,), 52, cuda,
                                                                      torch.float32, 0.1)
    args = _block_args(8, 197, 768, cuda, torch.bfloat16, seed=53)
    xa, mask, ws, ln = _bert_attn_args(8, 237, cuda, torch.bfloat16, seed=54)
    ln = tuple(v.to(torch.bfloat16) for v in ln)
    # B9 and B7 at one add_videos call's spatial shape, every vector bf16
    fb = tuple(t.to(torch.bfloat16) for t in _block_weights(cuda, torch.bfloat16, seed=55))
    xs = _randn((64, 197, 768), 56, cuda, torch.bfloat16)
    xq = _randn((64, 197, 3 * 768), 57, cuda, torch.bfloat16)
    # B11 at one add_videos call's spatial rows, B10 at its temporal shape;
    # K2 and B8 on the packed qkv at that shape, b_eff bf16
    xt = _randn((8, 8, 196, 768), 58, cuda, torch.bfloat16)
    xp = _randn((8, 8, 196, 3 * 768), 59, cuda, torch.bfloat16)
    # B15 at one add_videos call's frames, its bias bf16
    raw = _frames((8, 8, 224, 224, 3), 60, cuda)
    kp, bp = fb[4].t().contiguous(), fb[5]
    return {"patchify_embed": ((raw,), lambda r: preprocess.patchify_embed(r, kp, bp, _MEAN, _STD),
                               lambda r: preprocess.patchify_embed_plain(r, kp, bp, _MEAN, _STD),
                               2e-2),
            "ln_matmul": ((x,), lambda x: ln_matmul.ln_matmul(x, *fb[:4], eps=1e-6),
                          lambda x: ln_matmul.ln_matmul_plain(x, *fb[:4], 1e-6), 2e-2),
            "temporal_block": ((xt,), lambda x: fused_block.fused_temporal_block(
                x, *fb, 12, eps=1e-6),
                lambda x: fused_block.fused_temporal_block_reference(x, *fb, 12, 1e-6), 2e-2),
            "temporal_attn": ((xp,), lambda x: qkv_attn.temporal_attention_qkv(x, 12),
                              lambda x: qkv_attn.temporal_attention_plain(x, 12, 0.125), 1e-2),
            "temporal_qkv_proj": ((xp,), lambda x: qkv_attn.temporal_attention_qkv_proj(
                x, *fb[4:], 12),
                lambda x: qkv_attn.temporal_attention_qkv_proj_plain(x, *fb[4:], 12, 0.125),
                2e-2),
            "layernorm": ((x,), lambda x: layernorm.layernorm(x, s, b, eps=1e-6),
                          lambda x: layernorm.layernorm_plain(x, s, b, 1e-6, torch.bfloat16),
                          2e-2),
            "block_attn": ((args[0],), lambda x: block_attn.fused_attention_block(x, *args[1:], 12),
                           lambda x: block_attn.fused_attention_block_plain(x, *args[1:], 12),
                           2e-2),
            "bert_attn": ((xa,), lambda x: bert_block.bert_attention_block(x, mask, *ws, *ln, 12,
                                                                          eps=1e-12),
                          lambda x: bert_block.bert_attention_block_plain(x, mask, *ws, *ln, 12,
                                                                          1e-12),
                          3e-2),
            "fused_block": ((xs,), lambda x: fused_block.fused_spatial_block(
                x, *fb, 12, eps=1e-6, residual=True),
                lambda x: fused_block.fused_spatial_block_plain(x, *fb, 12, 1e-6, True), 2e-2),
            "qkv_proj": ((xq,), lambda x: qkv_attn.spatial_attention_qkv_proj(x, *fb[4:], 12),
                         lambda x: qkv_attn.spatial_attention_qkv_proj_plain(x, *fb[4:], 12,
                                                                             0.125), 2e-2)}


@pytest.mark.parametrize("kernel", ["layernorm", "block_attn", "bert_attn", "fused_block",
                                    "qkv_proj", "ln_matmul", "temporal_block", "temporal_attn",
                                    "temporal_qkv_proj", "patchify_embed"])
def test_kernel_launches_on_the_current_stream(cuda, kernel):
    """Under ``torch.cuda.stream(s)`` the launch lands on s: with the default
    stream asleep, its result is complete on s. Inside a CUDA-graph capture
    it lands on the capturing stream, its scratch allocated there too:
    replaying the graph on new inputs gives the twin's result for them, bit
    for bit the uncaptured call's."""
    (x,), fn, twin, tol = _stream_cases(cuda)[kernel]
    want = twin(x).float()
    side = torch.cuda.Stream()

    def on_side():
        with torch.cuda.stream(side):
            got = fn(x)
            return int(((got.float() - want).abs() > tol + tol * want.abs()).sum())  # syncs side

    # first on an idle card: the build, the module load and the side stream's
    # first allocations (a cudaMalloc may wait for the whole device) happen here
    on_side()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(2e9))  # about a second of the default stream
    bad = on_side()
    asleep = not torch.cuda.current_stream().query()
    torch.cuda.synchronize()
    assert asleep, "the default stream finished first: the check proves nothing"
    assert bad == 0

    static = x.clone()
    warm = torch.cuda.Stream()
    warm.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(warm):
        fn(static)
    torch.cuda.current_stream().wait_stream(warm)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn(static)
    fresh = (x.float() * 0.5 + 0.25).to(x.dtype)
    static.copy_(fresh)
    graph.replay()
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), twin(fresh).float(), atol=tol, rtol=tol)
    torch.testing.assert_close(out, fn(fresh), atol=0, rtol=0)


@pytest.mark.parametrize("form", ["frames", "patches"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_unfolded_uint8_normalize_is_the_cpus_bit_for_bit(cuda, form, dtype):
    """The video tower's unfolded uint8 normalize (``fold_uint8_norm='off'``,
    the fp32 default's path) gives the patch embedding the same fp32 values
    on the card as on the CPU, bit for bit, on raw frames and on
    pre-patchified rows: IEEE divisions, where a division by the Python
    scalar 255 is a multiply by its reciprocal on CUDA, one bit off at some
    v / 255. Every (value, channel) pair of the 768 occurs."""
    from alpro_tpu_torch.models.timesformer import TimeSformer, TimeSformerConfig

    cfg = TimeSformerConfig(img_size=32, num_frames=2, embed_dim=128, depth=1, num_heads=2,
                            fold_uint8_norm="off", drop_path_rate=0.0, attn_impl="plain",
                            temporal_attn_impl="plain", mlp_impl="plain")
    frames = (torch.arange(2 * 2 * 32 * 32 * 3) % 256).to(torch.uint8).view(2, 2, 32, 32, 3)
    if form == "patches":
        frames = frames.view(2, 2, 2, 16, 2, 16, 3).permute(0, 1, 2, 4, 3, 5, 6).reshape(
            2, 2, 4, 768)
    seen = []
    for dev in ("cpu", cuda):
        tower = TimeSformer(cfg, dtype).to(dev)
        tower.patch_embed.register_forward_pre_hook(lambda m, args: seen.append(args[0]))
        with torch.no_grad():
            tower(frames.to(dev))
    cpu, card = seen
    assert card.dtype == torch.float32 and card.device.type == "cuda"
    torch.testing.assert_close(card.cpu(), cpu, atol=0, rtol=0)


# ---- the exact GELU (``ops/gelu.py``, ``csrc/gelu.cu``; not a TPU kernel) ----
# the training path's fc1 output (24 clips x 16 frames x 196 patches, 3072),
# the CLS rows', and sizes whose n mod 8 (the bf16 vector) is not 0
GELU_SHAPES = [(75264, 3072), (24, 3072), (7, 3), (1, 13), (3, 1000003)]


def _gelu_inputs(shape, dtype, cuda, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = (torch.randn(shape, generator=g, device=cuda) * 3.0).to(dtype)
    dg = torch.randn(shape, generator=g, device=cuda).to(dtype)
    return x, dg


def _ulp(v: torch.Tensor, dtype) -> torch.Tensor:
    """The spacing of ``dtype`` at each |v| (its least subnormal at 0)."""
    fi = torch.finfo(dtype)
    frac = {torch.bfloat16: 7, torch.float32: 23}[dtype]
    m, e = torch.frexp(v.float().abs())
    ulp = torch.ldexp(torch.ones_like(m), e - 1 - frac)
    return torch.where(m == 0, torch.full_like(ulp, fi.tiny * fi.eps), ulp)


def _gelu_autograd(x, dg):
    from alpro_tpu_torch.ops import gelu

    h = x.detach().requires_grad_(True)
    (dh,) = torch.autograd.grad(gelu.gelu_plain(h), h, dg)
    return dh


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", GELU_SHAPES)
def test_gelu_forward_is_the_twin_bit_for_bit(cuda, dtype, shape):
    from alpro_tpu_torch.ops import gelu

    x, _ = _gelu_inputs(shape, dtype, cuda, seed=1)
    n = gelu.launches
    got = gelu.gelu(x)
    assert gelu.launches == n + 1 and got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got, gelu.gelu_plain(x))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gelu_forward_special_values(cuda, dtype):
    """Zeros, subnormals, the erf's saturation and large magnitudes, on the
    vector body, its scalar tail and the unaligned scalar body (a view that
    starts one element in)."""
    from alpro_tpu_torch.ops import gelu

    fi = torch.finfo(dtype)
    vals = torch.tensor([0.0, -0.0, fi.tiny, -fi.tiny, fi.tiny / 4, 1e-20, -1e-20, 0.5, -0.5,
                         -0.7517915, 3.9, -3.9, 5.5, -5.5, 10.0, -10.0, 1e4, -1e4, 1e30,
                         -1e30, fi.max, 2.0 ** -14, 1.0, -1.0, 7.0], device=cuda).to(dtype)
    for x in (vals, vals[1:]):
        assert torch.equal(gelu.gelu(x), gelu.gelu_plain(x))
        dg = torch.ones_like(x)
        got = gelu.gelu_backward(x, dg)
        want = _gelu_autograd(x, dg)
        both = torch.isfinite(want)
        assert torch.equal(torch.isfinite(got), both)
        assert bool(((got.float() - want.float()).abs()[both]
                     <= _ulp(want, dtype)[both] * (1 if dtype == torch.bfloat16 else 4)).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", GELU_SHAPES)
def test_gelu_backward_within_ulps_of_autograd(cuda, dtype, shape):
    """The custom op's backward (one ``gelu_bwd`` launch) against autograd
    through the twin: within one bf16 ulp, or four fp32 ulps, of each
    element."""
    from alpro_tpu_torch.ops import gelu

    x, dg = _gelu_inputs(shape, dtype, cuda, seed=2)
    h = x.clone().requires_grad_(True)
    n = (gelu.launches, gelu.backward_launches)
    y = gelu.gelu(h)
    (got,) = torch.autograd.grad(y, h, dg)
    assert (gelu.launches, gelu.backward_launches) == (n[0] + 1, n[1] + 1)
    want = _gelu_autograd(x, dg)
    del y, h
    ulps = 1 if dtype == torch.bfloat16 else 4
    miss = (got.float() - want.float()).abs() > ulps * _ulp(want, dtype)
    assert not bool(miss.any()), (int(miss.sum()), x[miss][:4], got[miss][:4], want[miss][:4])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gelu_repeats_bit_equal(cuda, dtype):
    from alpro_tpu_torch.ops import gelu

    x, dg = _gelu_inputs((9408, 3072), dtype, cuda, seed=3)
    first, first_dh = gelu.gelu(x), gelu.gelu_backward(x, dg)
    for _ in range(20):
        assert torch.equal(gelu.gelu(x), first)
        assert torch.equal(gelu.gelu_backward(x, dg), first_dh)


def test_gelu_refuses_what_it_does_not_take(cuda):
    from alpro_tpu_torch.ops import gelu

    x, dg = _gelu_inputs((64, 96), torch.bfloat16, cuda, seed=4)
    n = (gelu.launches, gelu.backward_launches)
    with pytest.raises(ValueError, match="contiguous"):
        gelu.gelu(x.t())
    with pytest.raises(ValueError, match="contiguous"):
        gelu.gelu(x.t().requires_grad_(True))
    with pytest.raises(ValueError, match="dtype"):
        gelu.gelu(x.half())
    with pytest.raises(ValueError, match="contiguous"):
        gelu.gelu_backward(x, dg.t().contiguous().t())
    with pytest.raises(ValueError, match="dtype"):
        gelu.gelu_backward(x, dg.float())
    assert (gelu.launches, gelu.backward_launches) == n


def test_gelu_launches_on_the_current_stream(cuda):
    """Under ``torch.cuda.stream(s)`` and inside a CUDA-graph capture."""
    from alpro_tpu_torch.ops import gelu

    x, dg = _gelu_inputs((4096, 3072), torch.bfloat16, cuda, seed=5)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        torch.cuda._sleep(50_000_000)
        got = gelu.gelu(x)
    s.synchronize()
    assert torch.equal(got, gelu.gelu_plain(x))
    static = x.clone()
    gelu.gelu(static)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out, dh = gelu.gelu(static), gelu.gelu_backward(static, dg)
    fresh = (x.float() * 0.5 + 0.25).to(x.dtype)
    static.copy_(fresh)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, gelu.gelu_plain(fresh))
    assert torch.equal(dh, gelu.gelu_backward(fresh, dg))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("policy", ["dots_ln", "nothing"])
def test_checkpointed_block_with_gelu_kernel_matches_plain(cuda, dtype, policy, monkeypatch):
    """A divided space-time block in training, checkpointed under
    ``policy``, with the GELU kernel: its forward twice (forward and
    recompute) on the CLS rows and the patches, its backward once each;
    gradients of the inputs and parameters against the same block on the
    plain path unchecked (autograd through the twin): relative L2 within
    1e-5 in fp32, the step tests' tolerance, and in bf16 within 1e-2, about
    one bf16 ulp (2^-7)."""
    from alpro_tpu_torch.models import timesformer
    from alpro_tpu_torch.models.remat import resolve_remat_policy
    from alpro_tpu_torch.models.timesformer import DividedSTBlock, TimeSformerConfig
    from alpro_tpu_torch.ops import gelu
    from alpro_tpu_torch.ops.layers import checkpoint

    cfg = TimeSformerConfig(img_size=64, patch_size=16, num_frames=4, embed_dim=256, depth=1,
                            num_heads=4)
    torch.manual_seed(0)
    blk = DividedSTBlock(cfg).to(cuda).train()
    g = torch.Generator(device=cuda).manual_seed(6)
    cls = torch.randn((2, 1, 256), generator=g, device=cuda).to(dtype)
    x = torch.randn((2, 4, 16, 256), generator=g, device=cuda).to(dtype)
    dc = torch.randn(cls.shape, generator=g, device=cuda).to(dtype)
    dx = torch.randn(x.shape, generator=g, device=cuda).to(dtype)

    def grads(run):
        blk.zero_grad(set_to_none=True)
        c, v = cls.clone().requires_grad_(True), x.clone().requires_grad_(True)
        oc, ov = run(c, v)
        torch.autograd.backward([oc, ov], [dc, dx])
        return [c.grad, v.grad] + [p.grad for p in blk.parameters()]

    def fwd(c, v):
        return blk(c, v, cfg, dtype, 0.0, None, None)

    with monkeypatch.context() as m:
        m.setattr(timesformer, "gelu_exact", gelu.gelu_plain)
        n = (gelu.launches, gelu.backward_launches)
        want = grads(fwd)
        assert (gelu.launches, gelu.backward_launches) == n
    got = grads(lambda c, v: checkpoint(fwd, None, c, v,
                                        context_fn=resolve_remat_policy(policy)))
    assert (gelu.launches, gelu.backward_launches) == (n[0] + 4, n[1] + 2)
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    for a, b in zip(got, want):
        assert float((a.float() - b.float()).norm()) <= tol * float(b.float().norm())


def test_qa_micro_step_launches_gelu_by_depth(cuda):
    """One QA micro-step (loss and backward) with the video tower
    checkpointed under ``dots_ln``: the GELU forward twice a block (CLS rows
    and patches) in the forward and again in the recompute, once a BERT
    layer; its backward once a block's call and once a layer."""
    import numpy as np

    from alpro_tpu_torch.models.alpro import build_qa_model, init_random_
    from alpro_tpu_torch.models.bert import BertConfig
    from alpro_tpu_torch.models.timesformer import TimeSformerConfig
    from alpro_tpu_torch.ops import gelu
    from alpro_tpu_torch.train.step import StepContext, qa_loss, step_generator

    bert = BertConfig(vocab_size=1000, hidden_size=256, num_hidden_layers=3,
                      num_attention_heads=4, intermediate_size=1024, fusion_layer=2)
    vis = TimeSformerConfig(img_size=64, patch_size=16, num_frames=4, embed_dim=256, depth=2,
                            num_heads=4, gradient_checkpointing=True, remat_policy="dots_ln")
    model = build_qa_model(bert, vis, img_size=64, num_frm=4, num_labels=7, dtype=torch.bfloat16)
    model = init_random_(model, torch.Generator().manual_seed(0)).to(cuda)
    assert model.visual_encoder.model.cfg.gradient_checkpointing
    rng = np.random.RandomState(1)
    ids = torch.from_numpy(rng.randint(1000, size=(4, 12))).to(cuda)
    batch = {"visual_inputs": torch.from_numpy(rng.randint(0, 256, (4, 4, 64, 64, 3),
                                                           dtype=np.uint8)).to(cuda),
             "text_input_ids": ids, "text_input_mask": torch.ones_like(ids),
             "labels": torch.from_numpy(rng.randint(0, 7, 4)).to(cuda)}
    model.train()
    n = (gelu.launches, gelu.backward_launches)
    g = step_generator(0, 0, cuda)
    loss, _ = qa_loss(model, batch, StepContext(g, g))
    loss.backward()
    torch.cuda.synchronize()
    depth, layers = vis.depth, bert.num_hidden_layers
    assert (gelu.launches - n[0], gelu.backward_launches - n[1]) == \
        (2 * depth * 2 + layers, 2 * depth + layers)
