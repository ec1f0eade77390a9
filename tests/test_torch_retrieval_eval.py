"""The port's batched retrieval builders and eval protocol against the JAX
package's on the same weights (JAX init → ``from_jax_params``), fp32 on the
CPU, JAX on its XLA lowerings.

- ``make_fusion_score_pairs_fn``, ``make_fusion_rerank_bank_fn`` and
  ``make_retrieval_inference_fn`` against their JAX builders: logits and VTC sims within 5e-4 (the parity gate's
  scores atol); the pair order is video-major (texts tiled, videos
  repeated), as JAX's.
- Twins of ``tests/test_retrieval_inference.py``: the cached-text batched
  protocol equals the naive one-video forward (sims 1e-5, logits 1e-5 as
  there); ``eval_rerank_topk`` K ≥ V ranks as K = 0, and K = 2 puts each
  text's VTC top-2 first; an eval set with no video gives no result (the
  single-process form of the empty shard).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alpro_tpu.models import BertConfig as JaxBertConfig
from alpro_tpu.models import TimeSformerConfig as JaxVisConfig
from alpro_tpu.models import build_retrieval_model as jax_build
from alpro_tpu_torch.checkpoint.load import from_jax_params
from alpro_tpu_torch.core.config import Config
from alpro_tpu_torch.models.alpro import build_retrieval_model
from alpro_tpu_torch.models.bert import BertConfig
from alpro_tpu_torch.models.timesformer import TimeSformerConfig
from alpro_tpu_torch.serving import inference as pinf

ATOL = 5e-4
VIS = dict(img_size=32, patch_size=16, num_frames=2, embed_dim=24, depth=2, num_heads=4,
           drop_path_rate=0.0)
BERT = dict(vocab_size=100, hidden_size=24, num_hidden_layers=2, num_attention_heads=4,
            intermediate_size=48, fusion_layer=1, hidden_dropout_prob=0.0,
            attention_probs_dropout_prob=0.0)


@pytest.fixture(scope="module")
def pair():
    jm = jax_build(JaxBertConfig(**BERT, block_impl="xla"), JaxVisConfig(**VIS))
    params = jm.init({"params": jax.random.PRNGKey(1)}, jnp.zeros((1, 2, 32, 32, 3)),
                     jnp.zeros((1, 8), jnp.int32), jnp.ones((1, 8), jnp.int32))
    port = build_retrieval_model(BertConfig(**BERT), TimeSformerConfig(**VIS))
    from_jax_params(port, params)
    rng = np.random.RandomState(0)
    clips = rng.randint(0, 256, (3, 2, 32, 32, 3)).astype(np.uint8)
    ids = rng.randint(0, 100, (5, 7)).astype(np.int32)
    mask = (rng.rand(5, 7) > 0.3).astype(np.int32)
    mask[:, 0] = 1
    mask[4] = 0  # an all-zero padded row, as the protocol pads its last chunk
    ids[4] = 0
    return jm, params, port, clips, ids, mask


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_builders_match_jax(pair):
    from alpro_tpu.train import step as jstep

    jm, params, port, clips, ids, mask = pair
    batch = {"text_input_ids": ids, "text_input_mask": mask}
    jte, jtf = jstep.make_text_encode_fn(jm)(params, batch)
    jve, _ = jstep.make_video_embed_fn(jm)(params, clips)
    pte, ptf = pinf.make_text_encode_fn(port)({k: _t(v) for k, v in batch.items()})
    pve, _ = pinf.make_video_embed_fn(port)(_t(clips))
    assert torch.isfinite(pte).all()  # the all-zero mask row stays finite
    np.testing.assert_allclose(ptf.numpy(), np.asarray(jtf), atol=ATOL, rtol=0)

    got = pinf.make_fusion_score_pairs_fn(port)(pte, _t(mask), pve)
    want = jstep.make_fusion_score_pairs_fn(jm)(params, jte, mask, jve)
    assert got.shape == (3, 5, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)

    tidx, vidx = np.asarray([0, 3, 4, 1, 2], np.int32), np.asarray([2, 0, 1, 1, 0], np.int32)
    got = pinf.make_fusion_rerank_bank_fn(port)(pte, _t(mask), pve, _t(tidx).long(),
                                                _t(vidx).long())
    want = jstep.make_fusion_rerank_bank_fn(jm)(params, jte, mask, jve, tidx, vidx)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)

    full = {"visual_inputs": clips[:1], **batch}
    got = pinf.make_retrieval_inference_fn(port)({k: _t(v) for k, v in full.items()})
    want = jstep.make_retrieval_inference_fn(jm)(params, full)
    for key in ("logits", "itc_scores"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=ATOL, rtol=0)


def test_fast_eval_equals_naive(pair):
    """The cached-text path (text once, video once, the V×C pair scorer and
    the bank scorer) reproduces the naive 1-video × N-texts forward."""
    _, _, port, clips, ids, mask = pair
    mask = mask.copy()
    mask[4, 0] = 1  # the naive forward scores real texts
    ids_t, mask_t = _t(ids), _t(mask)
    text_embeds, tfeat = pinf.make_text_encode_fn(port)(
        {"text_input_ids": ids_t, "text_input_mask": mask_t})
    vemb, vfeat = pinf.make_video_embed_fn(port)(_t(clips))
    pairs = pinf.make_fusion_score_pairs_fn(port)(text_embeds, mask_t, vemb)
    temp = float(np.clip(port.temp.detach().numpy(), 0.001, 0.5))
    for vi in range(3):
        naive = pinf.make_retrieval_inference_fn(port)(
            {"visual_inputs": _t(clips[vi:vi + 1]), "text_input_ids": ids_t,
             "text_input_mask": mask_t})
        np.testing.assert_allclose(vfeat[vi:vi + 1].numpy() @ tfeat.numpy().T / temp,
                                   naive["itc_scores"].numpy(), atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(pairs[vi].numpy(), naive["logits"].numpy(),
                                   atol=1e-5, rtol=1e-4)
    tidx, vidx = torch.tensor([0, 3, 4, 1]), torch.tensor([2, 0, 1, 1])
    bank = pinf.make_fusion_rerank_bank_fn(port)(text_embeds, mask_t, vemb, tidx, vidx)
    np.testing.assert_allclose(bank.numpy(), pairs[vidx, tidx].numpy(), atol=1e-5, rtol=1e-5)


class _EvalDS:
    """A duck-typed ``RetrievalEvalDataset``: n_videos seeded clips, n_text
    captions, text j's ground truth video j % n_videos."""

    CAPTIONS = ["a dog runs", "the red ball", "a person is playing", "rain on the window",
                "two cats sleep", "a car drives fast", "children play games", "the sun sets",
                "birds fly away"]

    def __init__(self, rng, n_videos=6, n_text=9):
        self.clips = rng.randint(0, 255, (n_videos, 2, 32, 32, 3)).astype(np.uint8)
        self.texts = [{"caption": self.CAPTIONS[j % 9], "txt_id": f"t{j}"} for j in range(n_text)]
        self.gt_txt_id2vid_id = {f"t{j}": f"v{j % max(n_videos, 1)}" for j in range(n_text)}

    def __len__(self):
        return len(self.clips)

    def get_video(self, i):
        return {"clip": self.clips[i], "vid_id": f"v{i}"}


def _ranking(results):
    by_txt = {}
    for r in results:
        by_txt.setdefault(r["txt_id"], []).append((-r["score"], r["vid_id"]))
    return {t: [v for _, v in sorted(rows)] for t, rows in by_txt.items()}


def test_eval_rerank_topk_full_k_matches_protocol(pair):
    from alpro_tpu.data.tokenization import WordPieceTokenizer, make_test_vocab
    from alpro_tpu_torch.cli.run_video_retrieval import inference_retrieval
    from alpro_tpu_torch.evals.retrieval import eval_retrieval

    port = pair[2]
    eval_ds, tok = _EvalDS(np.random.RandomState(3)), WordPieceTokenizer(make_test_vocab())
    base = dict(max_txt_len=8, inference_batch_size=4, eval_video_batch_size=4,
                eval_pair_batch_size=8)
    full = inference_retrieval(port, eval_ds, tok, Config(base))
    topk = inference_retrieval(port, eval_ds, tok, Config(dict(base, eval_rerank_topk=64)))
    assert len(topk) == len(full) == 6 * 9
    assert _ranking(topk) == _ranking(full)
    gt = eval_ds.gt_txt_id2vid_id
    assert eval_retrieval(topk, gt) == eval_retrieval(full, gt)

    k2 = inference_retrieval(port, eval_ds, tok, Config(dict(base, eval_rerank_topk=2)))
    r_full, r_k2 = _ranking(full), _ranking(k2)
    sims = {(r["vid_id"], r["txt_id"]): r["sim"] for r in k2}
    scores = {(r["vid_id"], r["txt_id"]): r["score"] for r in k2}
    for t, vids in r_k2.items():
        cand = set(sorted(vids, key=lambda v: -sims[(v, t)])[:2])
        assert set(vids[:2]) == cand
        assert all(scores[(v, t)] > 1.0 for v in vids[:2])
        assert all(scores[(v, t)] < 1.0 for v in vids[2:])
        if r_full[t][0] in cand:
            assert r_k2[t][0] == r_full[t][0]


def test_eval_rerank_topk_without_videos(pair):
    """No video to score (the single-process form of an empty shard): the
    top-K protocol returns no row instead of failing on an empty bank."""
    from alpro_tpu.data.tokenization import WordPieceTokenizer, make_test_vocab
    from alpro_tpu_torch.cli.run_video_retrieval import _inference_retrieval_topk

    eval_ds = _EvalDS(np.random.RandomState(4), n_videos=0)
    cfg = Config(max_txt_len=8, inference_batch_size=4, eval_video_batch_size=4,
                 eval_pair_batch_size=8)
    assert _inference_retrieval_topk(pair[2], eval_ds, WordPieceTokenizer(make_test_vocab()),
                                     cfg, K=2) == []
