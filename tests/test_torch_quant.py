"""Port int8 weight storage (``alpro_tpu_torch/ops/quant.py``) vs alpro_tpu's.

At widths where every matmul weight but the ``itm_head`` and the QA output
layer clears ``min_elems`` (the widths of ``tests/test_quant.py``): q and
scale bit-equal to JAX ``quantize_tree``'s and the set of quantized weights
the image of JAX's under the port's tree → ALPRO-key mapping; the int8
retrieval and QA serving paths against JAX's int8 paths at the bf16 parity
tests' tolerances (5e-4 on P(match), sims and logits), the JAX side
compiled without excess precision (``_exact_jit``: by default XLA keeps an
fp32 value across a bf16 round trip, where the port and eager JAX round
every bf16 value as written); the port's int8
against its own bf16 at ``tests/test_quant.py``'s envelopes; the caller's
model unchanged; ``int8_dense`` exact at K = 3072, where an fp32 sum is not.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alpro_tpu.data.tokenization import WordPieceTokenizer, make_test_vocab
from alpro_tpu.models import BertConfig as JaxBertConfig
from alpro_tpu.models import TimeSformerConfig as JaxVisCfg
from alpro_tpu.models import build_qa_model as jax_build_qa
from alpro_tpu.ops import quant as jquant
from alpro_tpu.serving import RetrievalIndex as JaxIndex
from alpro_tpu.serving.qa import VideoQAPredictor as JaxQA
from alpro_tpu_torch.checkpoint.from_jax import alpro_state_dict
from alpro_tpu_torch.checkpoint.load import _to_port_keys, from_jax_params
from alpro_tpu_torch.models.alpro import build_qa_model
from alpro_tpu_torch.models.bert import BertConfig
from alpro_tpu_torch.models.timesformer import TimeSformerConfig
from alpro_tpu_torch.ops import quant
from alpro_tpu_torch.serving.inference import make_video_embed_fn
from alpro_tpu_torch.serving.qa import VideoQAPredictor
from alpro_tpu_torch.serving.retrieval import RetrievalIndex

BERT = dict(vocab_size=100, hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=128, fusion_layer=1, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)
VIS = dict(img_size=32, patch_size=16, num_frames=2, embed_dim=64, depth=2, num_heads=2)
ANS2LABEL = {"cooking": 0, "running": 1, "eating": 2, "red": 3, "dog": 4}
TEXTS = ["a dog runs", "the cat jumps on the bed", "hello", "a person is playing"]
ATOL = 5e-4


_JIT = jax.jit


def _exact_jit(fn, **kw):
    """``jax.jit`` compiled with ``xla_allow_excess_precision`` off."""
    jitted, compiled = _JIT(fn, **kw), {}

    def call(*args):
        leaves, tree = jax.tree.flatten(args)
        key = (str(tree), *((np.shape(x), np.result_type(x)) for x in leaves))
        if key not in compiled:
            compiled[key] = jitted.lower(*args).compile(
                compiler_options={"xla_allow_excess_precision": False})
        return compiled[key](*args)

    return call


@pytest.fixture(scope="module")
def exact_jit():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax, "jit", _exact_jit)
        yield


@pytest.fixture(scope="module")
def pair():
    """The JAX QA model (the retrieval model plus the classifier) and its
    params, with LN scales and biases moved off 1/0, and the port's."""
    jm = jax_build_qa(JaxBertConfig(**BERT), JaxVisCfg(**VIS, drop_path_rate=0.0),
                      num_labels=len(ANS2LABEL), img_size=32, num_frm=2)
    params = jm.init({"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 2, 32, 32, 3)),
                     jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 8), jnp.int32))
    rng = np.random.RandomState(0)
    params = jax.tree.map(
        lambda x: x + np.float32(0.02) * np.asarray(rng.randn(*x.shape), np.float32), params)
    port = build_qa_model(BertConfig(**BERT), TimeSformerConfig(**VIS),
                          num_labels=len(ANS2LABEL), img_size=32, num_frm=2)
    from_jax_params(port, params)
    return jm, params, port


def _port_view(qparams, leaf):
    """``leaf(x)`` of each leaf of a JAX quantized tree (QTensor or array),
    carried into the port's names and layouts by the port's mapping."""
    tree = jax.tree.map(leaf, qparams, is_leaf=lambda x: isinstance(x, jquant.QTensor))
    return {k: v.numpy() for k, v in _to_port_keys(alpro_state_dict(tree)).items()}


@pytest.mark.parametrize("min_elems", [quant.MIN_ELEMS, 1 << 10])
def test_quantized_set_q_and_scale_bit_equal_to_jax(pair, min_elems):
    _, params, port = pair
    qparams = jquant.quantize_tree(params, min_elems=min_elems)
    is_q = _port_view(qparams, lambda x: np.full(x.shape, float(isinstance(x, jquant.QTensor)),
                                                  np.float32))
    want = {k for k, v in is_q.items() if v.size and v.min() == 1.0}
    picks = quant.quantized_weights(port, min_elems)
    assert {f"{m}.{p}" for m, p, _ in picks} == want
    assert "itm_head.weight" not in want and "visual_encoder.model.patch_embed.kernel" in want
    jq = _port_view(qparams, lambda x: np.asarray(x.q, np.float32)
                    if isinstance(x, jquant.QTensor) else np.zeros(x.shape, np.float32))
    js = _port_view(qparams, lambda x: np.broadcast_to(np.asarray(x.scale), x.shape)
                    if isinstance(x, jquant.QTensor) else np.zeros(x.shape, np.float32))
    qmodel = quant.quantize_tree(port, min_elems=min_elems)
    modules = dict(qmodel.named_modules())
    for m, p, _ in picks:
        holder = modules[m].parametrizations[p]
        q, scale = holder.original, holder[0].scale
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.float().numpy(), jq[f"{m}.{p}"])
        np.testing.assert_array_equal(scale.expand(q.shape).numpy(), js[f"{m}.{p}"])
    # every other parameter: fp32 → bf16, as JAX's other leaves
    for name, t in qmodel.named_parameters():
        assert t.dtype in (torch.int8, torch.bfloat16), name


def test_quantize_tree_leaves_the_model_and_dequantizes_per_read(pair):
    port = pair[2]
    before = {k: v.clone() for k, v in port.state_dict().items()}
    qmodel = quant.quantize_tree(port)
    assert all(torch.equal(v, before[k]) and v.dtype == torch.float32
               for k, v in port.state_dict().items())
    fc1 = qmodel.visual_encoder.model.blocks[0].mlp.fc1
    w1, w2 = fc1.weight, fc1.weight
    assert w1.dtype == torch.bfloat16 and w1 is not w2 and torch.equal(w1, w2)
    qt = quant.quantize_weight(port.visual_encoder.model.blocks[0].mlp.fc1.weight)
    assert torch.equal(w1, (qt.q.float() * qt.scale).to(torch.bfloat16))
    dense = quant.dequantize_tree(qmodel)
    assert dense.visual_encoder.model.blocks[0].mlp.fc1.weight.dtype == torch.bfloat16
    assert torch.equal(dense.visual_encoder.model.blocks[0].mlp.fc1.weight, w1)
    clips = torch.from_numpy(np.random.RandomState(2).randint(0, 255, (2, 2, 32, 32, 3),
                                                              np.uint8))
    embed = make_video_embed_fn(qmodel)
    got = quant.wrap_dequant(lambda m, x: make_video_embed_fn(m)(x))(qmodel, clips)
    for a, b, c in zip(embed(clips), got, make_video_embed_fn(dense)(clips)):
        assert torch.equal(a, b) and torch.equal(a, c)


def test_quantize_weight_rounding_and_zero_channels():
    rng = np.random.RandomState(0)
    w = rng.randn(48, 64).astype(np.float32) * np.exp(rng.randn(48, 1)).astype(np.float32)
    w[3] = 0.0                                   # a zero output channel (temporal_fc's init)
    w[5, :2] = [127.5 / 127, -127.5 / 127]       # ties at the channel's scale
    w[5, 2] = 1.0
    qt = quant.quantize_weight(torch.from_numpy(w), axis=-1, dtype=torch.float32)
    jt = jquant.quantize_weight(w.T, dtype=jnp.float32)
    np.testing.assert_array_equal(qt.q.numpy(), np.asarray(jt.q).T)
    np.testing.assert_array_equal(qt.scale.numpy(), np.asarray(jt.scale).T)
    assert qt.scale[3].item() == 0 and not qt.q[3].any() and not qt.dequant()[3].any()
    assert np.all(np.abs(qt.dequant().numpy() - w) <= qt.scale.numpy() / 2 + 1e-7)


def test_int8_dense_is_exact_at_k_3072():
    rng = np.random.RandomState(3)
    K = 3072
    x = rng.randn(6, K).astype(np.float32) * 10
    w = rng.randn(32, K).astype(np.float32)
    x[:3], w[:16] = 1 + rng.rand(3, K), 1 + rng.rand(16, K)  # sums of one sign: past 2^24
    b = rng.randn(32).astype(np.float32)
    qw = quant.quantize_weight(torch.from_numpy(w), dtype=torch.float32)
    got = quant.int8_dense(torch.from_numpy(x), qw, torch.from_numpy(b)).numpy()
    jqw = jquant.quantize_weight(w.T, dtype=jnp.float32)
    want = np.asarray(_exact_jit(jquant.int8_dense)(jnp.asarray(x), jqw, jnp.asarray(b)))
    # one fp32 ulp: XLA fuses the last rescale and the bias add into an FMA
    np.testing.assert_allclose(got, want, rtol=2 ** -23, atol=0)
    # the exact integer product, rescaled as int8_dense does
    xq, xs = quant.quantize_acts(torch.from_numpy(x))
    exact = xq.numpy().astype(np.int64) @ qw.q.numpy().astype(np.int64).T
    ref = exact.astype(np.float32) * xs.numpy() * qw.scale.numpy().T + b
    np.testing.assert_array_equal(got, ref)
    assert np.abs(exact).max() > 2 ** 24  # past fp32's exact integers
    f32 = (xq.float() @ qw.q.float().T).numpy().astype(np.int64)
    assert (f32 != exact).any()  # an fp32 product of the int8 values is not exact here
    # the dequantized float product, within the activations' rounding
    deq = (xq.double() * xs.double()) @ qw.q.double().T * qw.scale.double().T + \
        torch.from_numpy(b).double()
    np.testing.assert_allclose(got, deq.numpy(), rtol=1e-5, atol=1e-3)


def test_quantize_acts_round_trip_matches_jax():
    x = np.random.RandomState(4).randn(8, 64).astype(np.float32) * 10
    x[2] = 0.0
    q, s = quant.quantize_acts(torch.from_numpy(x))
    jq, js = jquant.quantize_acts(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    back = q.float() * s
    assert float((back - torch.from_numpy(x)).abs().max()) <= float(s.max()) / 2 + 1e-5


@pytest.fixture(scope="module")
def indexes(pair, exact_jit):
    jm, params, port = pair
    tok = WordPieceTokenizer(make_test_vocab())
    clips = np.random.RandomState(5).randint(0, 255, (5, 2, 32, 32, 3), np.uint8)
    out = {}
    for weights in ("bf16", "int8"):
        j = JaxIndex(jm, params, tok, max_txt_len=8, topk=5, weights=weights)
        p = RetrievalIndex(port, tok, "cpu", max_txt_len=8, topk=5, weights=weights)
        for idx in (j, p):
            idx.add_videos(clips[:2], ids=["v0", "v1"])
            idx.add_videos(clips[2:], ids=["v2", "v3", "v4"])
        out[weights] = (j, p)
    return out


def _same(got, want, atol):
    assert [g[0] for g in got] == [w[0] for w in want], (got, want)
    np.testing.assert_allclose([g[1:] for g in got], [w[1:] for w in want], atol=atol, rtol=0)


def test_int8_retrieval_matches_jax_int8(indexes, exact_jit):
    j, p = indexes["int8"]
    assert p.model is not indexes["bf16"][1].model
    feats, tokens = p._banks()
    np.testing.assert_allclose(feats.numpy(), np.concatenate(j._feat_chunks), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tokens.float().numpy(),
                               np.concatenate(j._token_chunks).astype(np.float32),
                               atol=2e-4, rtol=0)
    for text in TEXTS:
        _same(p.query(text), j.query(text), ATOL)
    for got, want in zip(p.query_batch(TEXTS, topk=3), j.query_batch(TEXTS, topk=3)):
        _same(got, want, ATOL)


def test_int8_retrieval_within_the_envelope_of_bf16(indexes, pair):
    """``tests/test_quant.py``'s envelopes: feature 0.08, tokens 0.25 against
    the model with every parameter in bf16; ranks and P(match), sims 0.05
    against the bf16 index."""
    port = pair[2]
    clips = torch.from_numpy(np.random.RandomState(4).randint(0, 255, (2, 2, 32, 32, 3),
                                                              np.uint8))
    ref_emb, ref_feat = make_video_embed_fn(copy.deepcopy(port).to(torch.bfloat16))(clips)
    q_emb, q_feat = make_video_embed_fn(quant.quantize_tree(port, min_elems=1 << 10))(clips)
    assert float((ref_feat.float() - q_feat.float()).abs().max()) < 0.08
    assert float((ref_emb.float() - q_emb.float()).abs().max()) < 0.25
    for text in TEXTS:
        _same(indexes["int8"][1].query(text), indexes["bf16"][1].query(text), 0.05)


def test_int8_qa_matches_jax_int8(pair, exact_jit):
    jm, params, port = pair
    tok = WordPieceTokenizer(make_test_vocab())
    jqa = JaxQA(jm, params, tok, ANS2LABEL, max_txt_len=8, weights="int8")
    pqa = VideoQAPredictor(port, tok, ANS2LABEL, device="cpu", max_txt_len=8, weights="int8")
    clips = np.random.RandomState(6).randint(0, 255, (3, 2, 32, 32, 3), np.uint8)
    feats = pqa.encode_video(clips)
    jfeats = jqa.encode_video(clips)
    want1 = {q: jqa.predict(clips, q, topk=5) for q in TEXTS[:2]}
    wantb = jqa.predict_batch(clips, TEXTS, topk=3)
    np.testing.assert_allclose(feats.float().numpy(), np.asarray(jfeats, np.float32),
                               atol=2e-4, rtol=0)
    for question, want in want1.items():
        for src in (clips, feats):
            got = pqa.predict(src, question, topk=5)
            assert [a for a, _ in got] == [a for a, _ in want]
            np.testing.assert_allclose([s for _, s in got], [s for _, s in want], atol=ATOL)
    for got, want in zip(pqa.predict_batch(feats, TEXTS, topk=3), wantb):
        assert [a for a, _ in got] == [a for a, _ in want]
        np.testing.assert_allclose([s for _, s in got], [s for _, s in want], atol=ATOL)
    with pytest.raises(ValueError, match="weights"):
        VideoQAPredictor(port, tok, ANS2LABEL, device="cpu", weights="fp8")
