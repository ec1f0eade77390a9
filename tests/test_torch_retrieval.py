"""Port RetrievalIndex vs alpro_tpu.serving.RetrievalIndex on one gallery.

Same weights (JAX init → ``from_jax_params``), same clips and texts: the same
ids rank for rank, P(match) and VTC sims within 5e-4 (docs/PARITY.md
scores gate). Banks saved by either package load in the other. The JAX side
runs its plain lowerings on the CPU (block_impl='xla').
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alpro_tpu.checkpoint.export_torch import export_reference_state_dict
from alpro_tpu.data.tokenization import WordPieceTokenizer, make_test_vocab
from alpro_tpu.models import BertConfig as JaxBertConfig
from alpro_tpu.models import TimeSformerConfig as JaxVisCfg
from alpro_tpu.models import build_retrieval_model as jax_build
from alpro_tpu.serving import RetrievalIndex as JaxIndex
from alpro_tpu_torch.checkpoint.load import from_jax_params, load_alpro_state_dict
from alpro_tpu_torch.models.alpro import build_retrieval_model
from alpro_tpu_torch.models.bert import BertConfig
from alpro_tpu_torch.models.timesformer import TimeSformerConfig
from alpro_tpu_torch.serving.retrieval import RetrievalIndex

BERT = dict(vocab_size=100, hidden_size=16, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=32, fusion_layer=1)
VIS = dict(img_size=32, patch_size=16, num_frames=2, embed_dim=16, depth=2, num_heads=2)
TEXTS = ["a dog runs", "the cat jumps", "hello", "a person is playing"]
ATOL = 5e-4


@pytest.fixture(scope="module")
def pair():
    jm = jax_build(JaxBertConfig(**BERT, block_impl="xla"),
                   JaxVisCfg(**VIS, drop_path_rate=0.0), img_size=32, num_frm=2)
    params = jm.init({"params": jax.random.PRNGKey(0)},
                     jnp.zeros((1, 2, 32, 32, 3), jnp.float32),
                     jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 8), jnp.int32))
    port = build_retrieval_model(BertConfig(**BERT), TimeSformerConfig(**VIS),
                                 img_size=32, num_frm=2)
    from_jax_params(port, params)
    tok = WordPieceTokenizer(make_test_vocab())
    jidx = JaxIndex(jm, params, tok, max_txt_len=8, topk=3)
    pidx = RetrievalIndex(port, tok, "cpu", max_txt_len=8, topk=3)
    clips = np.random.RandomState(0).randint(0, 255, (5, 2, 32, 32, 3), np.uint8)
    for idx in (jidx, pidx):
        idx.add_videos(clips[:2], ids=["v0", "v1"])
        idx.add_videos(clips[2:], ids=["v2", "v3", "v4"])  # incremental add
    return jm, params, port, jidx, pidx


def _same(got, want):
    assert [g[0] for g in got] == [w[0] for w in want], (got, want)
    np.testing.assert_allclose([g[1] for g in got], [w[1] for w in want], atol=ATOL, rtol=0)
    np.testing.assert_allclose([g[2] for g in got], [w[2] for w in want], atol=ATOL, rtol=0)


@pytest.mark.parametrize("topk", [None, 1, 5])
def test_query_matches_jax_index(pair, topk):
    *_, jidx, pidx = pair
    for text in TEXTS:
        _same(pidx.query(text, topk=topk), jidx.query(text, topk=topk))


def test_gallery_banks_match_jax(pair):
    *_, jidx, pidx = pair
    feats, tokens = pidx._banks()
    np.testing.assert_allclose(feats.numpy(), np.concatenate(jidx._feat_chunks),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(tokens.numpy(), np.concatenate(jidx._token_chunks),
                               atol=2e-4, rtol=0)


def test_query_batch_matches_query_and_jax(pair):
    *_, jidx, pidx = pair
    batched = pidx.query_batch(TEXTS, topk=4)
    assert len(batched) == len(TEXTS)
    for text, got in zip(TEXTS, batched):
        _same(got, pidx.query(text, topk=4))
        _same(got, jidx.query(text, topk=4))
    assert pidx.query_batch([], topk=3) == []


def test_banks_load_across_packages(pair, tmp_path):
    jm, params, port, jidx, pidx = pair
    tok = pidx.tokenizer
    pidx.save(str(tmp_path / "port_bank.npz"))
    jidx.save(str(tmp_path / "jax_bank"))

    j_from_port = JaxIndex(jm, params, tok, max_txt_len=8, topk=3)
    j_from_port.load(str(tmp_path / "port_bank.npz"))
    p_from_jax = RetrievalIndex(port, tok, "cpu", max_txt_len=8, topk=3)
    p_from_jax.load(str(tmp_path / "jax_bank"))
    assert j_from_port.ids == p_from_jax.ids == pidx.ids
    for text in TEXTS[:2]:
        _same(j_from_port.query(text), jidx.query(text))
        _same(p_from_jax.query(text), pidx.query(text))


def test_empty_index_raises_before_topk(pair):
    port = pair[2]
    empty = RetrievalIndex(port, pair[4].tokenizer, "cpu", max_txt_len=8, topk=3)
    for call in (lambda: empty.query("a dog"), lambda: empty.query("a dog", topk=0),
                 lambda: empty.query_batch(["a dog"]), lambda: empty.save("unused")):
        with pytest.raises(ValueError, match="empty index"):
            call()
    with pytest.raises(ValueError, match="topk"):
        pair[4].query("a dog", topk=0)


def test_int8_weights_not_ported(pair):
    """Int8 weight storage is ported: ``weights='int8'`` serves the gallery
    with the bf16 index's ranking within ``tests/test_quant.py``'s envelope
    (0.05), and any other value raises (``tests/test_torch_quant.py`` holds
    it to JAX's int8 index)."""
    port, pidx = pair[2], pair[4]
    idx8 = RetrievalIndex(port, pidx.tokenizer, "cpu", max_txt_len=8, topk=3, weights="int8")
    clips = np.random.RandomState(0).randint(0, 255, (5, 2, 32, 32, 3), np.uint8)
    idx8.add_videos(clips, ids=[f"v{i}" for i in range(5)])
    for text in TEXTS:
        got, want = idx8.query(text), pidx.query(text)
        assert [g[0] for g in got] == [w[0] for w in want], (got, want)
        np.testing.assert_allclose([g[1:] for g in got], [w[1:] for w in want], atol=0.05)
    with pytest.raises(ValueError, match="weights"):
        RetrievalIndex(port, pidx.tokenizer, "cpu", weights="fp8")


def test_from_jax_params_covers_every_parameter(pair):
    _, params, port, *_ = pair
    sd = export_reference_state_dict(params)
    names = {n for n, _ in port.named_parameters()}
    assert len(sd) == len(names)
    load_alpro_state_dict(port, sd)  # strict: no missing, no unexpected
    missing = dict(sd)
    missing.pop("temp")
    with pytest.raises(KeyError, match="temp"):
        load_alpro_state_dict(port, missing)
    with pytest.raises(KeyError, match="extra"):
        load_alpro_state_dict(port, {**sd, "extra.weight": np.zeros(3, np.float32)})
    bad = {**sd, "itm_head.weight": np.zeros((3, 16), np.float32)}
    with pytest.raises(ValueError, match="itm_head"):
        load_alpro_state_dict(port, bad)


def test_patch_embed_conv_weight_becomes_matmul_kernel(pair):
    """The (D, C, p, p) conv weight maps to the (p·p·C, D) kernel with rows
    in (ph, pw, c) order: conv over one patch == patch vector @ kernel."""
    _, params, port, *_ = pair
    sd = export_reference_state_dict(params)
    w = torch.from_numpy(sd["visual_encoder.model.patch_embed.proj.weight"])
    patch = torch.randn(1, 3, 16, 16, generator=torch.Generator().manual_seed(0))
    conv = torch.nn.functional.conv2d(patch, w, stride=16).flatten()
    vec = patch[0].permute(1, 2, 0).reshape(-1)  # (ph, pw, c)
    kernel = port.visual_encoder.model.patch_embed.kernel.detach()
    torch.testing.assert_close(vec @ kernel, conv, atol=1e-5, rtol=1e-5)
