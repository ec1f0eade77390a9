"""Fused BERT attention and MLP chains of the port (alpro_tpu_torch.ops.bert_block)
and ``BertModel(block_impl='fused')``, against alpro_tpu on the CPU.

The plain twins are held against the JAX references
(``_bert_attn_xla_reference`` / ``_bert_mlp_xla_reference``) and against
the Pallas kernel functions in interpret mode, in fp32 at atol 3e-5 (the
tolerance of tests/test_bert_block.py). The port's encoder with
``block_impl='fused'`` on a CPU tensor (the twins) is held against the JAX
encoder with ``block_impl='fused'`` (interpret mode) in its three modes at
atol 2e-4 (docs/PARITY.md activation gate). The CUDA kernels are held
against the twins on the card by tests/test_torch_cuda_kernels.py. The port
takes torch Linear layout weights, so every JAX kernel goes in transposed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alpro_tpu.models.bert import BertConfig as JaxBertConfig
from alpro_tpu.models.bert import BertModel as JaxBertModel
from alpro_tpu.ops.pallas_bert_block import (
    _bert_attn_xla_reference,
    _bert_mlp_xla_reference,
    fused_bert_attention_block,
    fused_bert_mlp_block,
)
from alpro_tpu_torch.checkpoint.from_jax import bert_state_dict
from alpro_tpu_torch.checkpoint.load import load_alpro_state_dict
from alpro_tpu_torch.models.bert import BertConfig, BertModel
from alpro_tpu_torch.ops import bert_block

ATOL_BLOCK = 3e-5
ATOL_MODEL = 2e-4
EPS = 1e-12


def _attn_inputs(seed, M=3, S=7, H=2, hd=8):
    rng = np.random.RandomState(seed)
    D = H * hd
    mask = (rng.rand(M, S) > 0.3).astype(np.float32)
    mask[:, 0] = 1.0
    mask[1, 4:] = 0.0  # a padded row tail
    w = [(rng.randn(D, D) * 0.2).astype(np.float32) if i % 2 == 0
         else (rng.randn(D) * 0.1).astype(np.float32) for i in range(8)]
    ln = [(1 + 0.1 * rng.randn(D)).astype(np.float32), (0.1 * rng.randn(D)).astype(np.float32)]
    return rng.randn(M, S, D).astype(np.float32), mask, w, ln, H


def _port_attn(fn, x, mask, w, ln, H):
    t = torch.from_numpy
    ws = [t(np.ascontiguousarray(a.T)) if a.ndim == 2 else t(a) for a in w]
    return fn(t(x), t(mask), *ws, t(ln[0]), t(ln[1]), H, eps=EPS).numpy()


@pytest.mark.parametrize("seed", [0, 1])
def test_attention_twin_matches_jax_reference_and_kernel(seed):
    x, mask, w, ln, H = _attn_inputs(seed)
    hd = x.shape[-1] // H
    j = [jnp.asarray(a) for a in (x, *w, *ln)]
    ref = _bert_attn_xla_reference(j[0], (1.0 - jnp.asarray(mask)) * -10000.0, *j[1:],
                                   EPS, hd ** -0.5, H)
    kern = fused_bert_attention_block(j[0], jnp.asarray(mask), *j[1:], H, eps=EPS)
    got = _port_attn(bert_block.bert_attention_block, x, mask, w, ln, H)
    twin = _port_attn(
        lambda *a, eps: bert_block.bert_attention_block_plain(*a, eps), x, mask, w, ln, H)
    np.testing.assert_array_equal(got, twin)  # a CPU tensor runs the twin
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL_BLOCK, rtol=0)
    np.testing.assert_allclose(got, np.asarray(kern), atol=ATOL_BLOCK, rtol=0)


def _contract_inputs(std_mul, M=2, S=24, H=2, hd=64):
    """bf16-sized inputs with a padded mask; the q/k/v/o weights at std
    ``std_mul``·D^-½ (4: scores in the tens)."""
    rng = np.random.RandomState(20 + std_mul)
    D = H * hd
    mask = np.ones((M, S), np.float32)
    mask[1, 17:] = 0.0
    w = [(rng.randn(D, D) * std_mul * D ** -0.5).astype(np.float32) if i % 2 == 0
         else (rng.randn(D) * 0.1).astype(np.float32) for i in range(8)]
    ln = [(1 + 0.1 * rng.randn(D)).astype(np.float32), (0.1 * rng.randn(D)).astype(np.float32)]
    return rng.randn(M, S, D).astype(np.float32), mask, w, ln, H


@pytest.mark.parametrize("std_mul", [1, 4])
def test_reference_holds_the_jax_kernels_rounding_points(std_mul):
    """``bert_attention_block_reference`` against the JAX kernel in interpret
    mode, everything in bf16 (as the serving layer passes it): within 2e-3.
    At std 4·D^-½ the twin, which keeps q, k and v in fp32, misses the same
    kernel by more than ten times that, so the reference, not the twin, is
    the contract the CUDA kernel is held to on the card."""
    x, mask, w, ln, H = _contract_inputs(std_mul)
    j = [jnp.asarray(a, jnp.bfloat16) for a in (x, *w, *ln)]
    kern = np.asarray(fused_bert_attention_block(j[0], jnp.asarray(mask), *j[1:], H, eps=EPS)
                      .astype(jnp.float32))

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a.T if a.ndim == 2 else a)).to(
            torch.bfloat16)

    args = (torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(mask),
            *(t(a) for a in w), *(t(a) for a in ln), H, EPS)
    ref = bert_block.bert_attention_block_reference(*args)
    assert ref.dtype == torch.bfloat16
    np.testing.assert_allclose(ref.float().numpy(), kern, atol=2e-3, rtol=0)
    if std_mul == 4:
        twin = bert_block.bert_attention_block_plain(*args).float().numpy()
        assert np.abs(twin - kern).max() > 10 * 2e-3


@pytest.mark.parametrize("shape", [(2, 9), (1, 5), (13,)])
def test_mlp_twin_matches_jax_reference_and_kernel(shape):
    rng = np.random.RandomState(len(shape))
    D, Dh = 16, 32
    x = rng.randn(*shape, D).astype(np.float32)
    args = [(rng.randn(D, Dh) * 0.2).astype(np.float32), (rng.randn(Dh) * 0.1).astype(np.float32),
            (rng.randn(Dh, D) * 0.2).astype(np.float32), (rng.randn(D) * 0.1).astype(np.float32),
            (1 + 0.1 * rng.randn(D)).astype(np.float32), (0.1 * rng.randn(D)).astype(np.float32)]
    j = [jnp.asarray(a) for a in (x, *args)]
    ref = _bert_mlp_xla_reference(*j, EPS)
    kern = fused_bert_mlp_block(*j, eps=EPS)
    t = torch.from_numpy
    targs = [t(np.ascontiguousarray(a.T)) if a.ndim == 2 else t(a) for a in args]
    got = bert_block.bert_mlp_block(t(x), *targs, eps=EPS).numpy()
    assert got.shape == x.shape
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL_BLOCK, rtol=0)
    np.testing.assert_allclose(got, np.asarray(kern), atol=ATOL_BLOCK, rtol=0)


def test_cpu_wrappers_launch_no_kernel_and_check_shapes():
    x, mask, w, ln, H = _attn_inputs(2)
    before = (bert_block.attn_launches, bert_block.mlp_launches)
    _port_attn(bert_block.bert_attention_block, x, mask, w, ln, H)
    assert (bert_block.attn_launches, bert_block.mlp_launches) == before
    t = torch.from_numpy
    with pytest.raises(ValueError, match="attention_mask"):
        _port_attn(bert_block.bert_attention_block, x, mask[:, :3], w, ln, H)
    with pytest.raises(ValueError, match="shape mismatch"):
        bert_block.bert_mlp_block(t(x), torch.zeros(32, 16), torch.zeros(32),
                                  torch.zeros(16, 31), torch.zeros(16), torch.ones(16),
                                  torch.zeros(16), eps=EPS)


BERT = dict(vocab_size=100, hidden_size=16, num_hidden_layers=3, num_attention_heads=2,
            intermediate_size=32, fusion_layer=2)


@pytest.fixture(scope="module")
def encoders():
    jm = JaxBertModel(JaxBertConfig(**BERT, block_impl="fused"))
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 6), jnp.int32),
                     jnp.ones((1, 6), jnp.int32), mode="multi_modal")
    port = BertModel(BertConfig(**BERT, block_impl="fused"))
    load_alpro_state_dict(port, bert_state_dict(params["params"], prefix=""))
    return jm, params, port


def _text(seed, B=3, L=6):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, 100, (B, L)).astype(np.int32)
    mask = np.ones((B, L), np.int32)
    mask[1, 4:] = 0
    mask[2, 2:] = 0
    return ids, mask


@pytest.mark.parametrize("mode", ["text", "multi_modal", "fusion"])
def test_fused_encoder_matches_jax_fused_encoder(encoders, mode):
    jm, params, port = encoders
    ids, mask = _text(3)
    t = torch.from_numpy
    kwargs, tkwargs = {}, {}
    if mode == "fusion":
        embeds = np.random.RandomState(4).randn(3, 6 + 5, 16).astype(np.float32)
        mask = np.concatenate([mask, np.ones((3, 5), np.int32)], axis=1)
        kwargs, tkwargs = dict(encoder_embeds=jnp.asarray(embeds)), dict(encoder_embeds=t(embeds))
    else:
        kwargs, tkwargs = dict(input_ids=jnp.asarray(ids)), dict(input_ids=t(ids))
    want = jm.apply(params, attention_mask=jnp.asarray(mask), mode=mode, **kwargs)
    before = (bert_block.attn_launches, bert_block.mlp_launches)
    with torch.no_grad():
        got = port(attention_mask=t(mask), mode=mode, **tkwargs)
        plain = BertModel(BertConfig(**BERT, block_impl="plain"))
        plain.load_state_dict(port.state_dict())
        want_plain = plain(attention_mask=t(mask), mode=mode, **tkwargs)
    assert (bert_block.attn_launches, bert_block.mlp_launches) == before
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL_MODEL, rtol=0)
    np.testing.assert_allclose(got.numpy(), want_plain.numpy(), atol=ATOL_MODEL, rtol=0)


def test_block_impl_resolves_auto_by_device():
    assert BertConfig().block_impl == "auto"
    cpu = torch.zeros(1)
    assert not BertConfig().use_fused(cpu)
    assert BertConfig(block_impl="fused").use_fused(cpu)
    assert not BertConfig(block_impl="xla").use_fused(cpu)
