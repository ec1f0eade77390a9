"""The multi-process layer on the card, at one process under NCCL.

Every test carries the ``cuda`` marker and skips without a CUDA device; the
file imports only torch and the port (no jax), so it runs on the machine
with the GPU: ``python -m pytest tests/test_torch_cuda_distributed.py -m
cuda --noconftest``. A NCCL process group of world size 1 on
``tcp://127.0.0.1`` at a free port, at narrow widths (BERT hidden 256, 2
layers; TimeSformer D 256, depth 2, 64², T 4), bf16 compute: the wrapped
retrieval step (``train/step.py::shard_step``) bit-equal to the unwrapped
one over 2 AdamW steps with dropout and drop-path 0.1 under ``attn_impl
'pallas'``, B13 launched alike; ``ShardedRetrievalIndex`` equal to
``RetrievalIndex`` (ids, P(match) and similarities bit-equal) with the same
K1-K5 launches; its ``save`` (the rows sent to rank 0 by NCCL) read back
whole by ``RetrievalIndex.load``, and its ``load`` serving the same answers
from a bf16 bank on the card.
"""

import copy
import os
import socket

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def nccl():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (NCCL runs only on the card)")
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    try:
        yield torch.device("cuda")
    finally:
        dist.destroy_process_group()


def _narrow(cuda, build, **kw):
    from alpro_tpu_torch.models.alpro import init_random_
    from alpro_tpu_torch.models.bert import BertConfig
    from alpro_tpu_torch.models.timesformer import TimeSformerConfig

    bert = BertConfig(vocab_size=1000, hidden_size=256, num_hidden_layers=2,
                      num_attention_heads=4, intermediate_size=1024, fusion_layer=1, **kw)
    vis = TimeSformerConfig(img_size=64, patch_size=16, num_frames=4, embed_dim=256, depth=2,
                            num_heads=4, drop_rate=0.1, drop_path_rate=0.1, **kw)
    model = build(bert, vis, img_size=64, num_frm=4, dtype=torch.bfloat16)
    return init_random_(model, torch.Generator().manual_seed(0)).to(cuda)


def _tok(texts, max_length=12):
    ids = np.zeros((len(texts), max_length), np.int32)
    mask = np.zeros_like(ids)
    for i, t in enumerate(texts):
        row = [101, *(100 + sum(map(ord, w)) % 800 for w in t.split())][: max_length - 1] + [102]
        ids[i, : len(row)], mask[i, : len(row)] = row, 1
    return {"input_ids": ids, "attention_mask": mask}


def test_wrapped_step_is_bit_equal_to_the_unwrapped_step(nccl):
    from alpro_tpu_torch.core.mesh import make_mesh
    from alpro_tpu_torch.models.alpro import build_retrieval_model
    from alpro_tpu_torch.ops import masked_attn
    from alpro_tpu_torch.train.optimizer import build_optimizer, get_lr_schedule
    from alpro_tpu_torch.train.state import TrainState
    from alpro_tpu_torch.train.step import make_retrieval_train_step, shard_step

    model = _narrow(nccl, build_retrieval_model, attn_impl="pallas")
    rng = np.random.RandomState(1)
    tok = _tok(["a dog runs", "a cat", "two people dance here", "rain on a window"])
    batch = {"visual_inputs": torch.from_numpy(rng.randint(0, 256, (4, 4, 64, 64, 3),
                                                           dtype=np.uint8)).to(nccl),
             "text_input_ids": torch.from_numpy(tok["input_ids"]).long().to(nccl),
             "text_input_mask": torch.from_numpy(tok["attention_mask"]).long().to(nccl)}
    runs = []
    for wrapped in (False, True):
        m = copy.deepcopy(model)
        opt = build_optimizer(get_lr_schedule("linear", 1e-4, 10), grad_norm=5.0)
        state, step = TrainState.create(m, opt), make_retrieval_train_step(m, opt)
        if wrapped:
            step = shard_step(step, make_mesh([1]))
        metrics, launches = [], []
        for _ in range(2):
            n = masked_attn.bshd_launches
            metrics.append({k: float(v) for k, v in step(state, batch, 3)[1].items()})
            launches.append(masked_attn.bshd_launches - n)
        runs.append((metrics, launches, dict(m.named_parameters())))
    (m0, l0, p0), (m1, l1, p1) = runs
    assert m0 == m1 and l0 == l1 and l0[0] > 0
    assert all(torch.equal(p0[n], p1[n]) for n in p0)


def test_sharded_index_equals_the_retrieval_index(nccl):
    from alpro_tpu_torch.core.mesh import make_mesh
    from alpro_tpu_torch.models.alpro import build_retrieval_model
    from alpro_tpu_torch.ops import bert_block, ln_mlp, qkv_attn
    from alpro_tpu_torch.serving.retrieval import RetrievalIndex
    from alpro_tpu_torch.serving.sharded import ShardedRetrievalIndex

    def counts():
        return (qkv_attn.spatial_launches, qkv_attn.temporal_launches, ln_mlp.launches,
                bert_block.attn_launches, bert_block.mlp_launches)

    class Tok:
        def __call__(self, texts, max_length=12):
            return _tok(texts, max_length)

    model = _narrow(nccl, build_retrieval_model).eval()
    clips = np.random.RandomState(2).randint(0, 256, (7, 4, 64, 64, 3), dtype=np.uint8)
    ids = [f"v{i}" for i in range(7)]
    texts = ["a dog runs", "a cat", "two people dance here"]
    out = []
    for index in (RetrievalIndex(model, Tok(), "cuda", max_txt_len=12, topk=4),
                  ShardedRetrievalIndex(model, Tok(), "cuda", make_mesh([1]), max_txt_len=12,
                                        topk=4)):
        before = counts()
        index.add_videos(clips[:4], ids[:4])
        index.add_videos(clips[4:], ids[4:])
        got = [index.query(t) for t in texts] + [index.query_batch(texts)]
        out.append((got, [a - b for a, b in zip(counts(), before)]))
    assert out[1] == out[0]
    assert all(n > 0 for n in out[0][1])


def test_sharded_index_save_and_load(nccl, tmp_path):
    from alpro_tpu_torch.core.mesh import make_mesh
    from alpro_tpu_torch.models.alpro import build_retrieval_model
    from alpro_tpu_torch.serving import sharded
    from alpro_tpu_torch.serving.retrieval import RetrievalIndex

    class Tok:
        def __call__(self, texts, max_length=12):
            return _tok(texts, max_length)

    model = _narrow(nccl, build_retrieval_model).eval()
    clips = np.random.RandomState(3).randint(0, 256, (5, 4, 64, 64, 3), dtype=np.uint8)
    ids = [f"v{i}" for i in range(5)]
    texts = ["a dog runs", "two people dance here"]
    index = sharded.ShardedRetrievalIndex(model, Tok(), "cuda", make_mesh([1]), max_txt_len=12,
                                          topk=3)
    index.add_videos(clips[:3], ids[:3])
    index.add_videos(clips[3:], ids[3:])
    block = sharded.SAVE_BLOCK
    sharded.SAVE_BLOCK = 2  # the 5 rows in 3 blocks
    try:
        index.save(os.path.join(tmp_path, "bank"))
    finally:
        sharded.SAVE_BLOCK = block
    whole = RetrievalIndex(model, Tok(), "cuda", max_txt_len=12, topk=3)
    whole.load(os.path.join(tmp_path, "bank"))
    feats, tokens, _ = index._banks()
    assert whole.ids == ids
    assert torch.equal(whole._banks()[0], feats) and torch.equal(whole._banks()[1], tokens.float())
    loaded = sharded.ShardedRetrievalIndex(model, Tok(), "cuda", make_mesh([1]), max_txt_len=12,
                                           topk=3)
    loaded.load(os.path.join(tmp_path, "bank"))
    assert loaded._banks()[1].dtype == torch.bfloat16 and loaded._banks()[1].is_cuda
    assert [loaded.query(t) for t in texts] == [index.query(t) for t in texts]
