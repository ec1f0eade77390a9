"""``serving/sharded.py::ShardedRetrievalIndex`` on two gloo processes.

The toy retrieval weights of ``tests/test_torch_dp_step.py`` (fp32), a
gallery of 5 clips added in two calls (3 and 2: each call's slice padded on
the second process), 3 texts. Held: ``query`` and ``query_batch`` against
the JAX ``ShardedRetrievalIndex`` on a 2-device mesh — the same ids in the
same order, P(match) and the VTC similarity within 5e-4; the same on both
processes; against the port's one-process ``RetrievalIndex`` within 1e-5,
with ``weights='int8'`` too; each process holding 3 of the padded 6 rows;
and ``save`` writing the whole gallery, which ``RetrievalIndex.load`` reads
back equal to the one-process bank and a sharded ``load`` serves alike,
each process reading its own rows of the file. One spawn of
``tests/torch_dist_worker.py``.
"""

import os

import jax
import numpy as np
import pytest
import torch

import torch_dist_worker as W
from alpro_tpu.core.mesh import make_mesh
from alpro_tpu.data.tokenization import WordPieceTokenizer as JaxTokenizer
from alpro_tpu.data.tokenization import make_test_vocab
from alpro_tpu.serving import ShardedRetrievalIndex as JaxShardedIndex
from alpro_tpu_torch.data.tokenization import WordPieceTokenizer
from alpro_tpu_torch.core.mesh import make_mesh as make_port_mesh
from alpro_tpu_torch.serving.retrieval import RetrievalIndex
from alpro_tpu_torch.serving.sharded import ShardedRetrievalIndex, _npz_member
from test_torch_dp_step import _pair

TEXTS = ["a dog runs", "a cat sleeps on a mat", "people play music"]
CALLS = [(0, 3), (3, 5)]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("index"))
    jm, params, port = _pair("retrieval", 11)
    clips = np.random.RandomState(5).randint(0, 256, (5, 2, 32, 32, 3)).astype(np.uint8)
    ids = [f"v{i}" for i in range(5)]
    inputs = {"state": port.state_dict(), "clips": clips, "ids": ids, "calls": CALLS,
              "texts": TEXTS, "dir": workdir}
    torch.save(inputs, os.path.join(workdir, "index_in.pt"))
    jidx = JaxShardedIndex(jm, params, JaxTokenizer(make_test_vocab()),
                           mesh=make_mesh(devices=jax.devices()[:2]), max_txt_len=8, topk=3)
    for lo, hi in CALLS:
        jidx.add_videos(clips[lo:hi], ids[lo:hi])
    want = {"query": [jidx.query(t) for t in TEXTS], "batch": jidx.query_batch(TEXTS)}
    return inputs, port.eval(), want, W.spawn("index", 2, workdir)


def _same(got, want, atol):
    assert [[h[0] for h in q] for q in got] == [[h[0] for h in q] for q in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose([h[1:] for h in g], [h[1:] for h in w], atol=atol, rtol=0)


def test_sharded_index_matches_jax(setup):
    _, _, want, out = setup
    for o in out:
        _same(o["bf16"]["query"], want["query"], 5e-4)
        _same(o["bf16"]["batch"], want["batch"], 5e-4)
        assert o["bf16"]["rows"] == 3  # (3 + 1 pad) / 2 + 2 / 2
    assert out[0]["bf16"] == out[1]["bf16"]


@pytest.mark.parametrize("weights", ["bf16", "int8"])
def test_sharded_index_matches_one_process(setup, weights):
    inputs, port, _, out = setup
    index = RetrievalIndex(port, WordPieceTokenizer(make_test_vocab()), "cpu", max_txt_len=8,
                           topk=3, weights=weights)
    for lo, hi in CALLS:
        index.add_videos(inputs["clips"][lo:hi], inputs["ids"][lo:hi])
    for o in out:
        _same(o[weights]["query"], [index.query(t) for t in TEXTS], 1e-5)
        _same(o[weights]["batch"], index.query_batch(TEXTS), 1e-5)


def test_sharded_index_opens_the_serving_spans(setup):
    """On every process each ``add_videos`` is an ``alpro.ingest`` span (the
    copy of its slice, then the video tower) and each ``query`` or
    ``query_batch`` an ``alpro.query`` span (tokenize, the text half, the
    fusion half, the readback), as on one process."""
    for o in setup[3]:
        spans = o["spans"]
        tops = sorted((s for s in spans if s["parent"] is None), key=lambda s: s["start"])
        assert [t["name"] for t in tops] == (["alpro.ingest"] * len(CALLS)
                                             + ["alpro.query"] * (len(TEXTS) + 1))
        for t in tops:
            kids = sorted((s for s in spans if s["parent"] == t["id"]), key=lambda s: s["start"])
            assert [k["name"] for k in kids] == (
                ["alpro.ingest.h2d", "alpro.video"] if t["name"] == "alpro.ingest" else
                ["alpro.query.tokenize", "alpro.text", "alpro.fusion", "alpro.query.readback"])
            assert all(t["start"] <= k["start"] <= k["end"] <= t["end"] for k in kids)
        assert len(spans) == len(tops) + sum(2 if t["name"] == "alpro.ingest" else 4
                                             for t in tops)


def test_saved_sharded_gallery_loads_whole(setup):
    inputs, port, _, out = setup
    for o in out:  # loaded back into a sharded index (other slices): the same answers
        _same(o["loaded"], o["bf16"]["query"], 1e-6)
    tok = WordPieceTokenizer(make_test_vocab())
    whole = RetrievalIndex(port, tok, "cpu", max_txt_len=8, topk=3)
    for lo, hi in CALLS:
        whole.add_videos(inputs["clips"][lo:hi], inputs["ids"][lo:hi])
    loaded = RetrievalIndex(port, tok, "cpu", max_txt_len=8, topk=3)
    loaded.load(os.path.join(inputs["dir"], "bank"))
    assert loaded.ids == inputs["ids"]
    for a, b in zip(loaded._banks(), whole._banks()):
        torch.testing.assert_close(a, b.float(), atol=1e-6, rtol=0)


def test_sharded_load_reads_its_slice(setup, tmp_path):
    inputs, port, _, out = setup
    # 5 saved rows over 2 processes: 3 each, the second's last a pad row
    assert [o["loaded_gidx"] for o in out] == [[0, 1, 2], [3, 4, -1]]
    npz = os.path.join(inputs["dir"], "bank.npz")
    with np.load(npz) as data:
        for name in ("feats", "tokens"):
            got = _npz_member(npz, name)
            assert isinstance(got, np.memmap)
            np.testing.assert_array_equal(got, data[name])
    # a bank of bf16 bits as the JAX package saves it, compressed too
    rng = np.random.RandomState(0)
    tokens = torch.from_numpy(rng.randn(3, 5, 32).astype(np.float32)).bfloat16()
    feats = rng.randn(3, 16).astype(np.float32)
    bits = tokens.view(torch.int16).numpy().view(np.dtype("V2"))
    for save in (np.savez, np.savez_compressed):
        save(tmp_path / "jax.npz", feats=feats, tokens=bits)
        (tmp_path / "jax.ids.json").write_text('["a", "b", "c"]')
        index = ShardedRetrievalIndex(port, WordPieceTokenizer(make_test_vocab()), "cpu",
                                      make_port_mesh([1]))
        index.load(str(tmp_path / "jax"))
        f, t, g = index._banks()
        assert index.ids == ["a", "b", "c"] and g.tolist() == [0, 1, 2]
        assert t.dtype == port.dtype
        torch.testing.assert_close(t, tokens.to(port.dtype), atol=0, rtol=0)
        torch.testing.assert_close(f, torch.from_numpy(feats), atol=0, rtol=0)
