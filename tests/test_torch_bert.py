"""Port split BERT and ALPRO heads vs alpro_tpu on the same weights.

The JAX model runs ``block_impl='xla'`` (the plain layers) and the port its
plain layers (the fused path is held against JAX's in
tests/test_torch_bert_block.py). fp32 activations within atol 2e-4,
features and logits within 5e-4 (docs/PARITY.md:151-170).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alpro_tpu.models import BertConfig as JaxBertConfig
from alpro_tpu.models import TimeSformerConfig as JaxVisCfg
from alpro_tpu.models import build_retrieval_model as jax_build
from alpro_tpu_torch.checkpoint.load import from_jax_params
from alpro_tpu_torch.models.alpro import build_retrieval_model, init_random_
from alpro_tpu_torch.models.bert import BertConfig
from alpro_tpu_torch.models.timesformer import TimeSformerConfig

BERT = dict(vocab_size=100, hidden_size=32, num_hidden_layers=3,
            num_attention_heads=4, intermediate_size=64, fusion_layer=2)
VIS = dict(img_size=32, patch_size=16, num_frames=2, embed_dim=32, depth=1, num_heads=4)


@pytest.fixture(scope="module")
def models():
    jm = jax_build(JaxBertConfig(**BERT, block_impl="xla"),
                   JaxVisCfg(**VIS, drop_path_rate=0.0), img_size=32, num_frm=2)
    params = jm.init({"params": jax.random.PRNGKey(0)},
                     jnp.zeros((1, 2, 32, 32, 3), jnp.float32),
                     jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 8), jnp.int32))
    port = build_retrieval_model(BertConfig(**BERT, block_impl="xla"),
                                 TimeSformerConfig(**VIS), img_size=32, num_frm=2)
    from_jax_params(port, params)
    return jm, params, port


def _text(seed):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, 100, (3, 8)).astype(np.int32)
    mask = np.ones((3, 8), np.int32)
    mask[1, 5:] = 0
    mask[2, 3:] = 0
    return ids, mask


def test_text_half_and_text_feat_match_jax(models):
    jm, params, port = models
    ids, mask = _text(0)
    want = jm.apply(params, jnp.asarray(ids), jnp.asarray(mask), method=jm.embed_text)
    want_feat = jm.apply(params, want, method=jm.text_feat)
    with torch.no_grad():
        got = port.embed_text(torch.from_numpy(ids), torch.from_numpy(mask))
        got_feat = port.text_feat(got)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0)
    np.testing.assert_allclose(got_feat.numpy(), np.asarray(want_feat), atol=5e-4, rtol=0)


def test_fusion_half_and_itm_match_jax(models):
    jm, params, port = models
    ids, mask = _text(1)
    rng = np.random.RandomState(2)
    text = rng.randn(3, 8, 32).astype(np.float32)
    video = rng.randn(3, 5, 32).astype(np.float32)
    want = jm.apply(params, jnp.asarray(text), jnp.asarray(mask), jnp.asarray(video),
                    method=jm.fuse)
    want_logits = jm.apply(params, want[:, 0, :], method=jm.itm_logits)
    with torch.no_grad():
        got = port.fuse(torch.from_numpy(text), torch.from_numpy(mask),
                        torch.from_numpy(video))
        got_logits = port.itm_logits(got[:, 0, :])
    assert got.shape == (3, 8 + 5, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits), atol=5e-4, rtol=0)


def test_temperature_clamped(models):
    _, _, port = models
    with torch.no_grad():
        port.temp.fill_(2.0)
        assert float(port.temperature()) == 0.5
        port.temp.fill_(0.0)
        assert float(port.temperature()) == pytest.approx(0.001)
        port.temp.fill_(0.07)


def test_fused_block_impl_raises():
    """``fused`` is a lowering of its own now; a value the port does not
    know raises instead of falling back to another lowering."""
    assert BertConfig(block_impl="fused").block_impl == "fused"
    for other in ("pallas", "flash", ""):
        with pytest.raises(ValueError):
            BertConfig(block_impl=other)
    assert BertConfig.from_json_dict({"hidden_size": 64, "hidden_act": "gelu"}).hidden_size == 64


def test_init_random_is_seeded_and_keeps_layernorm_identity():
    def fresh(seed):
        m = build_retrieval_model(BertConfig(**BERT), TimeSformerConfig(**VIS),
                                  img_size=32, num_frm=2)
        return init_random_(m, torch.Generator().manual_seed(seed))

    a, b, c = fresh(0), fresh(0), fresh(1)
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(), c.parameters()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0)
        if name == "temp":
            assert pa.item() == pytest.approx(0.07)
        elif "LayerNorm" in name or "norm" in name.split(".")[-2]:
            assert torch.all(pa == (1.0 if name.endswith("weight") else 0.0)), name
        else:
            assert not torch.equal(pa, pc), name

