"""Port VideoQAPredictor and the QA inference functions vs alpro_tpu.

Same weights (JAX init → the port's own ``from_jax_params``), same clips and
questions, at the toy dims of tests/test_serving.py: per-clip logits within
atol 5e-4 (docs/PARITY.md scores gate) and the same answers in the same
order under mean, max and lse pooling, from pixels and from cached video
tokens, one question at a time and batched. The JAX side runs its plain
lowerings on the CPU. Also: the multi-choice ``n_options`` path, the pooling
copy, the port's tree → ALPRO-key mapping against the JAX exporter, and one
tokenizer call per question.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alpro_tpu.checkpoint.export_torch import export_reference_state_dict
from alpro_tpu.data.tokenization import WordPieceTokenizer, make_test_vocab
from alpro_tpu.evals.qa import pool_clip_logits as jax_pool
from alpro_tpu.models import BertConfig as JaxBertConfig
from alpro_tpu.models import TimeSformerConfig as JaxVisCfg
from alpro_tpu.models import build_qa_model as jax_build_qa
from alpro_tpu.models import build_retrieval_model as jax_build_retrieval
from alpro_tpu.serving.qa import VideoQAPredictor as JaxQA
from alpro_tpu.train.step import _qa_logits
from alpro_tpu_torch.checkpoint.from_jax import alpro_state_dict
from alpro_tpu_torch.checkpoint.load import from_jax_params, load_alpro_state_dict
from alpro_tpu_torch.evals.qa import pool_clip_logits
from alpro_tpu_torch.models.alpro import build_qa_model
from alpro_tpu_torch.models.bert import BertConfig
from alpro_tpu_torch.models.timesformer import TimeSformerConfig
from alpro_tpu_torch.serving.inference import make_qa_inference_fn, qa_logits
from alpro_tpu_torch.serving.qa import VideoQAPredictor

BERT = dict(vocab_size=100, hidden_size=16, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=32, fusion_layer=1)
VIS = dict(img_size=32, patch_size=16, num_frames=2, embed_dim=16, depth=2, num_heads=2)
ANS2LABEL = {"cooking": 0, "running": 1, "eating": 2, "red": 3, "dog": 4}
QUESTIONS = ["what is the man doing", "what color is the ball", "who runs", "a dog"]
ATOL = 5e-4


def _init(jm):
    return jm.init({"params": jax.random.PRNGKey(0)},
                   jnp.zeros((1, 2, 32, 32, 3), jnp.float32),
                   jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 8), jnp.int32))


def _pair(num_labels):
    jm = jax_build_qa(JaxBertConfig(**BERT), JaxVisCfg(**VIS, drop_path_rate=0.0),
                      num_labels=num_labels, img_size=32, num_frm=2)
    params = _init(jm)
    port = build_qa_model(BertConfig(**BERT), TimeSformerConfig(**VIS),
                          num_labels=num_labels, img_size=32, num_frm=2)
    from_jax_params(port, params)
    return jm, params, port.eval()


@pytest.fixture(scope="module")
def qa():
    jm, params, port = _pair(len(ANS2LABEL))
    tok = WordPieceTokenizer(make_test_vocab())
    jqa = JaxQA(jm, params, tok, ANS2LABEL, max_txt_len=8)
    pqa = VideoQAPredictor(port, tok, ANS2LABEL, device="cpu", max_txt_len=8)
    clips = np.random.RandomState(1).randint(0, 255, (3, 2, 32, 32, 3), np.uint8)
    return jqa, pqa, clips


def _same(got, want):
    assert [a for a, _ in got] == [a for a, _ in want], (got, want)
    np.testing.assert_allclose([p for _, p in got], [p for _, p in want], atol=ATOL, rtol=0)


@pytest.mark.parametrize("pool", ["mean", "max", "lse"])
def test_predict_matches_jax_from_pixels_and_cache(qa, pool):
    jqa, pqa, clips = qa
    feats, jfeats = pqa.encode_video(clips), jqa.encode_video(clips)
    np.testing.assert_allclose(feats.numpy(), np.asarray(jfeats), atol=2e-4, rtol=0)
    for q in QUESTIONS[:2]:
        want = jqa.predict(clips, q, topk=5, pool=pool)
        _same(pqa.predict(clips, q, topk=5, pool=pool), want)
        _same(pqa.predict(feats, q, topk=5, pool=pool), want)
        _same(pqa.predict(feats, q, topk=5, pool=pool), jqa.predict(jfeats, q, topk=5, pool=pool))


@pytest.mark.parametrize("pool", ["mean", "max", "lse"])
def test_predict_batch_matches_jax_and_predict(qa, pool):
    jqa, pqa, clips = qa
    feats = pqa.encode_video(clips)
    got = pqa.predict_batch(clips, QUESTIONS, topk=3, pool=pool)
    want = jqa.predict_batch(clips, QUESTIONS, topk=3, pool=pool)
    assert len(got) == len(QUESTIONS)
    for q, g, w, c in zip(QUESTIONS, got, want,
                          pqa.predict_batch(feats, QUESTIONS, topk=3, pool=pool)):
        _same(g, w)
        _same(c, g)
        _same(g, pqa.predict(feats, q, topk=3, pool=pool))
    assert pqa.predict_batch(feats, []) == []


def test_per_clip_logits_match_jax(qa):
    jqa, pqa, clips = qa
    enc = pqa.tokenizer([QUESTIONS[0]] * 3, max_length=8)
    ids, mask = (np.asarray(enc[k], np.int32) for k in ("input_ids", "attention_mask"))
    want = jqa._infer(jqa.params, {"text_input_ids": jnp.asarray(ids),
                                   "text_input_mask": jnp.asarray(mask),
                                   "visual_inputs": jnp.asarray(clips)})
    got = make_qa_inference_fn(pqa.model)({"text_input_ids": torch.from_numpy(ids),
                                           "text_input_mask": torch.from_numpy(mask),
                                           "visual_inputs": torch.from_numpy(clips)})
    assert got.dtype == torch.float32 and got.shape == (3, len(ANS2LABEL))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_multi_choice_logits_match_jax():
    jm, params, port = _pair(1)
    rng = np.random.RandomState(2)
    B, K = 2, 2
    ids = rng.randint(1, 100, (B * K, 8)).astype(np.int32)
    mask = np.ones((B * K, 8), np.int32)
    mask[1, 5:] = 0
    video = rng.randn(B, 5, 16).astype(np.float32)  # one cached video per question
    want = _qa_logits(jm, params, {"text_input_ids": jnp.asarray(ids),
                                   "text_input_mask": jnp.asarray(mask),
                                   "video_embeds": jnp.asarray(video)},
                      jax.random.PRNGKey(0), train=False, n_options=K)
    with torch.no_grad():
        got = qa_logits(port, {"text_input_ids": torch.from_numpy(ids),
                               "text_input_mask": torch.from_numpy(mask),
                               "video_embeds": torch.from_numpy(video)}, n_options=K)
    assert got.shape == (B, K)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("method", ["mean", "max", "lse"])
def test_pool_clip_logits_matches_jax(method):
    logits = np.random.RandomState(3).randn(4, 3, 7).astype(np.float32) * 5
    np.testing.assert_allclose(pool_clip_logits(logits, method), jax_pool(logits, method),
                               rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="pool"):
        pool_clip_logits(logits, "median")


def test_predict_batch_tokenizes_each_question_once(qa):
    _, pqa, clips = qa
    calls = []

    def counting(texts, max_length):
        calls.append(list(texts))
        return pqa.tokenizer(texts, max_length=max_length)

    counted = VideoQAPredictor(pqa.model, counting, ANS2LABEL, device="cpu", max_txt_len=8)
    got = counted.predict_batch(clips, QUESTIONS, topk=2)
    assert calls == [QUESTIONS]  # one call, each question once, for 3 clips
    for g, w in zip(got, pqa.predict_batch(clips, QUESTIONS, topk=2)):
        _same(g, w)
    calls.clear()
    counted.predict(clips, QUESTIONS[0])
    assert calls == [[QUESTIONS[0]]]


def test_int8_weights_not_ported_and_bad_inputs(qa):
    """Int8 weight storage is ported: ``weights='int8'`` answers as the bf16
    predictor does, within ``tests/test_quant.py``'s envelope (0.05), from
    pixels and from its cached tokens (``tests/test_torch_quant.py`` holds
    it to JAX's int8 predictor); bad inputs raise."""
    _, pqa, clips = qa
    q8 = VideoQAPredictor(pqa.model, pqa.tokenizer, ANS2LABEL, device="cpu", max_txt_len=8,
                          weights="int8")
    feats = q8.encode_video(clips)
    for question in QUESTIONS:
        want = pqa.predict(clips, question, topk=5)
        for got in (q8.predict(clips, question, topk=5), q8.predict(feats, question, topk=5)):
            np.testing.assert_allclose([dict(got)[a] for a, _ in want], [p for _, p in want],
                                       atol=0.05)
    with pytest.raises(ValueError, match="clips"):
        pqa.predict(clips[0], "what")
    with pytest.raises(ValueError, match="clips"):
        pqa.encode_video(clips[0])


@pytest.mark.parametrize("kind", ["retrieval", "qa"])
def test_port_mapping_equals_jax_exporter(kind):
    if kind == "qa":
        jm, params, port = _pair(len(ANS2LABEL))
    else:
        jm = jax_build_retrieval(JaxBertConfig(**BERT), JaxVisCfg(**VIS, drop_path_rate=0.0),
                                 img_size=32, num_frm=2)
        params = _init(jm)
        port = None
    want = export_reference_state_dict(params)
    got = alpro_state_dict(params)
    assert list(got) == list(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype and got[key].shape == value.shape, key
        np.testing.assert_array_equal(got[key], value, err_msg=key)
    if port is not None:  # strict: no missing or unexpected key
        assert {k for k in got if k.startswith("classifier.")} == {
            "classifier.0.weight", "classifier.0.bias", "classifier.2.weight",
            "classifier.2.bias"}
        load_alpro_state_dict(port, got)
    with pytest.raises(KeyError, match="sop_head"):  # a subtree the port does not map
        alpro_state_dict({"params": {**params["params"], "sop_head": {}}})
