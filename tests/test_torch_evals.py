"""The port's eval metrics against the JAX package's, exactly, and a twin of
``tests/test_eval_planted.py`` on the port's retrieval protocol.

Metrics: ``retrieval_metrics_from_matrix``, ``retrieval_metrics_multi_gt``,
``eval_retrieval`` (the 1:1 and the multi-caption protocols, duplicates,
caption-less videos) and ``evaluate_qa`` (open-ended with answer types, some
missing; multi-choice) on seeded matrices and results: equal dicts.

Planted ranking: the port's K = 0 ``inference_retrieval`` (device 'cpu', fp32)
over a 13-video, 21-text gallery (4-video blocks: 1 + 3 padded; 8-text
chunks: 5 + 3 padded), a layout-independent re-derivation of a
(video block × text chunk) grid at other batch positions (P(match) within
1e-5, VTC sims within 1e-4, as the JAX test), and the metric pipeline
recovering a planted per-text argmax ranking (text→video R@1 = 100).
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

import alpro_tpu.evals.qa as jqa
import alpro_tpu.evals.retrieval as jret
import alpro_tpu_torch.evals.qa as pqa
import alpro_tpu_torch.evals.retrieval as pret

_SPEC = importlib.util.spec_from_file_location(
    "full_eval_check",
    os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                 "benchmarks", "full_eval_check.py"),
)
full_eval_check = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(full_eval_check)


@pytest.mark.parametrize("seed", range(4))
def test_retrieval_metrics_match_jax(seed):
    rng = np.random.default_rng(seed)
    nq, nc = 17, 23
    scores = rng.standard_normal((nq, nc)).astype(np.float32)
    scores[:, 5] = scores[:, 6]  # exact ties: the stable sort decides both the same way
    gt = rng.integers(0, nc, nq)
    assert pret.retrieval_metrics_from_matrix(scores, gt) == \
        jret.retrieval_metrics_from_matrix(scores, gt)
    multi = [sorted(rng.choice(nc, int(rng.integers(1, 4)), replace=False).tolist())
             for _ in range(nq)]
    assert pret.retrieval_metrics_multi_gt(scores, multi) == \
        jret.retrieval_metrics_multi_gt(scores, multi)


def _pairs(rng, vids, txts, dup=False):
    rows = [dict(vid_id=v, txt_id=t, score=float(rng.random()), sim=float(rng.standard_normal()))
            for v in vids for t in txts]
    if dup:  # a duplicate (txt, vid) pair: the first occurrence is kept
        rows.append(dict(rows[3], score=9.0))
    return rows


@pytest.mark.parametrize("protocol", ["one_to_one", "multi_caption", "captionless_video"])
def test_eval_retrieval_matches_jax(protocol):
    rng = np.random.default_rng(7)
    vids = [f"v{i}" for i in range(9)]
    if protocol == "one_to_one":
        txts = [f"t{i}" for i in range(9)]
        gt = {t: v for t, v in zip(txts, vids)}
    elif protocol == "multi_caption":
        txts = [f"t{i}" for i in range(18)]
        gt = {t: vids[i // 2] for i, t in enumerate(txts)}
    else:
        txts = [f"t{i}" for i in range(6)]
        gt = {t: vids[i] for i, t in enumerate(txts)}
    results = _pairs(rng, vids, txts, dup=True)
    assert pret.eval_retrieval(results, gt) == jret.eval_retrieval(results, gt)


@pytest.mark.parametrize("task", ["msrvtt_qa", "msvd_qa", "frameqa", "action"])
def test_evaluate_qa_matches_jax(task):
    rng = np.random.default_rng(len(task))
    answers = ["dog", "cat", "ball", "red", "two"]
    types = list(pqa.ANSWER_TYPES.get(task, {"x": 0}))
    qid2data, results = {}, []
    for q in range(30):
        if task == "action":
            qid2data[q] = {"answer": int(rng.integers(0, 5))}
            results.append({"question_id": q, "answer": int(rng.integers(0, 5))})
            continue
        row = {"answer": answers[rng.integers(0, 5)]}
        if q % 7:  # some rows carry no answer type
            row["answer_type"] = types[q % len(types)]
        qid2data[q] = row
        results.append({"question_id": q, "answer": int(rng.integers(0, 5))})
    label2ans = dict(enumerate(answers))
    assert pqa.ANSWER_TYPES == jqa.ANSWER_TYPES and pqa.OPEN_ENDED == jqa.OPEN_ENDED
    assert pqa.evaluate_qa(results, qid2data, label2ans, task) == \
        jqa.evaluate_qa(results, qid2data, label2ans, task)


def test_planted_ranking_full_protocol():
    from alpro_tpu_torch.cli.run_video_retrieval import inference_retrieval
    from alpro_tpu_torch.core.config import Config
    from alpro_tpu_torch.models.alpro import build_retrieval_model, init_random_
    from alpro_tpu_torch.models.bert import BertConfig
    from alpro_tpu_torch.models.timesformer import TimeSformerConfig
    from alpro_tpu_torch.serving.inference import (make_fusion_score_pairs_fn,
                                                   make_text_encode_fn, make_video_embed_fn)

    T, S, L = 2, 32, 10
    N_VIDEOS, N_TEXTS = 13, 21
    EVAL_BSZ, VID_BSZ = 8, 4
    vis = TimeSformerConfig(img_size=S, patch_size=16, num_frames=T, embed_dim=24, depth=2,
                            num_heads=4, drop_path_rate=0.0)
    bert = BertConfig(vocab_size=100, hidden_size=24, num_hidden_layers=2,
                      num_attention_heads=4, intermediate_size=48, fusion_layer=1,
                      hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                      initializer_range=0.3)
    model = init_random_(build_retrieval_model(bert, vis), torch.Generator().manual_seed(2))

    rng = np.random.RandomState(11)
    eval_ds = full_eval_check.PlantedEvalDS(rng, N_VIDEOS, N_TEXTS, T, S)
    tok = full_eval_check.HashTokenizer(bert.vocab_size)
    cfg = Config(max_txt_len=L, inference_batch_size=EVAL_BSZ, eval_video_batch_size=VID_BSZ)
    results = inference_retrieval(model, eval_ds, tok, cfg)
    assert len(results) == N_VIDEOS * N_TEXTS
    score = np.full((N_VIDEOS, N_TEXTS), np.nan, np.float32)
    sim = np.full((N_VIDEOS, N_TEXTS), np.nan, np.float32)
    for r in results:
        score[int(r["vid_id"][1:]), int(r["txt_id"][1:])] = r["score"]
        sim[int(r["vid_id"][1:]), int(r["txt_id"][1:])] = r["sim"]
    assert not np.isnan(score).any()

    # layout-independent spot check: block corners and chunk corners, shuffled
    svi = np.asarray([3, 12, 4, 0], np.int64)
    sti = np.asarray([8, 0, 20, 15, 7, 16, 2, 10], np.int64)
    clips = torch.from_numpy(np.stack([eval_ds.get_video(int(i))["clip"] for i in svi]))
    enc = tok([eval_ds.texts[int(j)]["caption"] for j in sti], max_length=L)
    ids, mask = (torch.from_numpy(np.asarray(enc[k], np.int32))
                 for k in ("input_ids", "attention_mask"))
    te, tf = make_text_encode_fn(model)({"text_input_ids": ids, "text_input_mask": mask})
    ve, vf = make_video_embed_fn(model)(clips)
    probs = torch.softmax(make_fusion_score_pairs_fn(model)(te, mask, ve), -1)[..., 1].numpy()
    temp = float(np.clip(model.temp.detach().numpy(), 0.001, 0.5))
    sims_t = vf.numpy() @ tf.numpy().T / temp
    np.testing.assert_allclose(score[np.ix_(svi, sti)], probs, atol=1e-5, rtol=0)
    np.testing.assert_allclose(sim[np.ix_(svi, sti)], sims_t, atol=1e-4, rtol=0)

    gt = {f"t{j}": f"v{int(np.argmax(score[:, j]))}" for j in range(N_TEXTS)}
    metrics = pret.eval_retrieval(results, gt)
    assert metrics["text2video"]["r1"] == 100.0
    assert metrics["text2video"]["medianR"] == metrics["text2video"]["meanR"] == 1.0
    assert 0.0 <= metrics["video2text"]["r1"] <= 100.0
