"""Int8 serving, the joint attention type's K1 length and the remat policies,
on the card.

Every test carries the ``cuda`` marker and skips without a CUDA device; the
file imports only torch and the port (no jax), so it runs on the machine
with the GPU: ``python -m pytest tests/test_torch_cuda_variants.py -m cuda``.
K1 at the joint tower's S = 1 + 8·196 = 1569 against its twin: bf16 within
K1's 3e-2, fp32 within 1e-5 where ``spatial_fits`` takes it and refused by
the wrapper's check, not a failed launch, where it does not. Int8 serving at
narrow widths: the weights int8 on the card, the caller's model unchanged,
the kernel path against the int8 plain path (features within 2e-2, P(match)
within 3e-2, chip_smoke's kernel-vs-plain tolerances). One QA step under
``--attn_impl pallas`` with the checkpointed video tower: under every
policy the loss and gradients of the step without checkpointing (the
recompute replays the same launches on the same inputs), and B13 launched
once per spatial block and BERT layer plus once more per block in the
recompute, except under the names family, which keeps B13's output; the
offload policy's kept tensors in pinned host memory.
"""

import dataclasses

import numpy as np
import pytest
import torch

from alpro_tpu_torch.ops import _build, masked_attn, qkv_attn

pytestmark = pytest.mark.cuda

NAMES = ("names", "dots_names", "dots_ln_names", "dots_ln_offload")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k1_at_the_joint_length_matches_twin_or_is_refused(cuda, dtype):
    H, hd, M, S = 12, 64, 2, 1 + 8 * 196
    g = torch.Generator().manual_seed(S)
    x = torch.randn((M, S, 3 * H * hd), generator=g).to(cuda, dtype)
    fits = qkv_attn.spatial_fits(M, S, H, hd, dtype, _build.smem_optin(cuda))
    if not fits:
        with pytest.raises(ValueError, match="spatial kernel"):
            qkv_attn.spatial_attention_qkv(x, H)
        return
    n = qkv_attn.spatial_launches
    got = qkv_attn.spatial_attention_qkv(x, H)
    torch.cuda.synchronize()
    assert qkv_attn.spatial_launches == n + 1
    want = qkv_attn.spatial_attention_plain(x, H, hd ** -0.5)
    tol = 3e-2 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


def _narrow(cuda, build, seed=0, **kw):
    from alpro_tpu_torch.models.alpro import init_random_
    from alpro_tpu_torch.models.bert import BertConfig
    from alpro_tpu_torch.models.timesformer import TimeSformerConfig

    bert = BertConfig(vocab_size=1000, hidden_size=256, num_hidden_layers=2,
                      num_attention_heads=4, intermediate_size=1024, fusion_layer=1)
    vis = TimeSformerConfig(img_size=64, patch_size=16, num_frames=4, embed_dim=256, depth=2,
                            num_heads=4)
    model = build(bert, vis, img_size=64, num_frm=4, **kw)
    return init_random_(model, torch.Generator().manual_seed(seed)).to(cuda)


def _tok(texts, max_length=12):
    ids = np.zeros((len(texts), max_length), np.int32)
    mask = np.zeros_like(ids)
    for i, t in enumerate(texts):
        row = [101, *(100 + sum(map(ord, w)) % 800 for w in t.split())][: max_length - 1] + [102]
        ids[i, : len(row)], mask[i, : len(row)] = row, 1
    return {"input_ids": ids, "attention_mask": mask}


def test_int8_serving_kernels_match_int8_plain(cuda):
    from alpro_tpu_torch.models.alpro import build_qa_model, build_retrieval_model
    from alpro_tpu_torch.serving.qa import VideoQAPredictor
    from alpro_tpu_torch.serving.retrieval import RetrievalIndex

    model = _narrow(cuda, build_retrieval_model).to(torch.bfloat16)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    clips = np.random.RandomState(0).randint(0, 256, (6, 4, 64, 64, 3), np.uint8)
    texts = ["a dog runs", "the cat", "a man cooks"]
    idx = RetrievalIndex(model, _tok, cuda, max_txt_len=12, topk=4, weights="int8")
    assert all(t.dtype in (torch.int8, torch.bfloat16) and t.is_cuda
               for t in idx.model.parameters())
    assert sum(t.dtype == torch.int8 for t in idx.model.parameters()) > 20
    n = qkv_attn.spatial_launches
    idx.add_videos(clips, [f"v{i}" for i in range(6)])
    kern = {t: idx.query(t, topk=6) for t in texts}
    assert qkv_attn.spatial_launches == n + 2
    vis, bert = idx.model.visual_encoder.model, idx.model.text_encoder.bert
    vis.cfg = dataclasses.replace(vis.cfg, attn_impl="plain", temporal_attn_impl="plain",
                                  mlp_impl="plain")
    bert.cfg = dataclasses.replace(bert.cfg, block_impl="plain")
    plain = RetrievalIndex(idx.model, _tok, cuda, max_txt_len=12, topk=4)
    plain.add_videos(clips, [f"v{i}" for i in range(6)])
    assert qkv_attn.spatial_launches == n + 2
    feat_err = float((idx._banks()[0] - plain._banks()[0]).abs().max())
    assert feat_err < 2e-2, feat_err
    for t in texts:
        p_k, p_p = dict((v, p) for v, p, _ in kern[t]), dict(
            (v, p) for v, p, _ in plain.query(t, topk=6))
        assert max(abs(p_k[v] - p_p[v]) for v in p_p) < 3e-2, t
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())

    qa_model = _narrow(cuda, build_qa_model, num_labels=7).to(torch.bfloat16)
    labels = {f"a{i}": i for i in range(7)}
    qa8 = VideoQAPredictor(qa_model, _tok, labels, cuda, max_txt_len=12, weights="int8")
    feats = qa8.encode_video(clips[:2])
    got = qa8.predict(feats, "what is it", topk=7)
    qa16 = VideoQAPredictor(qa_model, _tok, labels, cuda, max_txt_len=12)
    want = dict(qa16.predict(clips[:2], "what is it", topk=7))
    assert max(abs(p - want[a]) for a, p in got) < 0.05


@pytest.mark.parametrize("policy", ["nothing", "dots", "dots_all", "dots_names", "names",
                                    "dots_rng", "dots_ln", "dots_ln_offload", "dots_ln_names"])
def test_b13_launches_and_gradients_per_policy(cuda, policy, monkeypatch):
    from alpro_tpu_torch.models import remat
    from alpro_tpu_torch.models.alpro import build_qa_model
    from alpro_tpu_torch.train.step import StepContext, qa_loss, step_generator

    model = _narrow(cuda, build_qa_model, num_labels=7, dtype=torch.bfloat16,
                    attn_impl="pallas")
    vis = model.visual_encoder.model
    rng = np.random.RandomState(1)
    tok = _tok(["what is the man doing", "who sings", "how many", "a dog"])
    batch = {"visual_inputs": torch.from_numpy(rng.randint(0, 256, (4, 4, 64, 64, 3),
                                                           dtype=np.uint8)).to(cuda),
             "text_input_ids": torch.from_numpy(tok["input_ids"]).long().to(cuda),
             "text_input_mask": torch.from_numpy(tok["attention_mask"]).long().to(cuda),
             "labels": torch.from_numpy(rng.randint(0, 7, 4)).to(cuda)}

    def step(name):
        vis.cfg = dataclasses.replace(vis.cfg, gradient_checkpointing=name is not None,
                                      remat_policy=name or "nothing")
        model.train()
        model.zero_grad(set_to_none=True)
        n = masked_attn.bshd_launches
        g = step_generator(0, 0, cuda)
        loss, _ = qa_loss(model, batch, StepContext(g, g))
        loss.backward()
        torch.cuda.synchronize()
        return loss.item(), {k: p.grad.clone() for k, p in model.named_parameters()
                             if p.grad is not None}, masked_attn.bshd_launches - n

    ref_loss, ref, n_ref = step(None)
    pinned = []
    put = remat._Kept.put
    monkeypatch.setattr(remat._Kept, "put",
                        lambda self, t: (put(self, t), pinned.append(self.items[-1].is_pinned())))
    loss, grads, n = step(policy)
    assert n_ref == 2 + 2  # the video tower's 2 spatial attentions, BERT's 2 layers
    assert n == n_ref + (0 if policy in NAMES else 2), (policy, n)
    if policy == "dots_ln_offload":
        assert pinned and all(pinned)
    elif policy in NAMES:
        assert pinned and not any(pinned)
    assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
    assert grads.keys() == ref.keys()
    whole = torch.cat([(grads[k] - g).float().flatten() for k, g in ref.items()]).norm()
    assert float(whole) <= 1e-5 * float(torch.cat([g.float().flatten() for g in ref.values()]).norm())
