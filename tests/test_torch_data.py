"""The port's host data path against the JAX package's, bit for bit.

Tokenizer ids and masks (unknown words, punctuation, truncation), frame
sampling for every strategy and seed, the shorter-side resize (the port's
numpy bilinear against JAX's Pillow ``Image.BILINEAR``: exact, no uint8
level of difference allowed), ``read_video`` on ``.npy``/``.npz``, the eval
datasets' items, the collators' batches and ``BatchLoader``'s order. A
container path goes to the FFmpeg backend (its decoding against JAX's:
``tests/test_torch_media.py``), and a pandas ``.pkl`` datalist reads as
JAX's.
"""

import json
import os
import subprocess

import numpy as np
import pytest

import alpro_tpu.data.datasets as jds
import alpro_tpu.data.loader as jloader
import alpro_tpu.data.sampling as jsampling
import alpro_tpu.data.tokenization as jtok
import alpro_tpu.data.transforms as jtransforms
import alpro_tpu.media as jmedia
import alpro_tpu_torch.data.datasets as pds
import alpro_tpu_torch.data.loader as ploader
import alpro_tpu_torch.data.sampling as psampling
import alpro_tpu_torch.data.tokenization as ptok
import alpro_tpu_torch.data.transforms as ptransforms
import alpro_tpu_torch.media as pmedia
from fixtures import (CAPTIONS, make_clip, write_multichoice_qa_dataset, write_qa_dataset,
                      write_video_dataset)

TEXTS = CAPTIONS + [
    "A Dog, runs!", "the zebra's quest: 42 unicorns?", "", "   ", "dog-cat;ball.",
    "supercalifragilistic " * 3, "what is the red ball " * 10, "Café naïve résumé",
]


def _same_tree(got, want):
    assert type(got) is type(want) or isinstance(got, np.ndarray)
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _same_tree(got[k], want[k])
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same_tree(g, w)
    else:
        assert got == want


@pytest.mark.parametrize("max_length", [4, 12, 40])
def test_tokenizer_matches_jax(max_length):
    vocab = jtok.make_test_vocab(["zebra", "quest"])
    assert ptok.make_test_vocab(["zebra", "quest"]) == vocab
    got = ptok.WordPieceTokenizer(vocab)(TEXTS, max_length=max_length)
    want = jtok.WordPieceTokenizer(vocab)(TEXTS, max_length=max_length)
    _same_tree(got, want)
    p, j = ptok.WordPieceTokenizer(vocab), jtok.WordPieceTokenizer(vocab)
    for text in TEXTS:
        assert p.tokenize(text) == j.tokenize(text)
        ids = p.encode(text, max_length)
        assert p.decode_pieces(ids) == j.decode_pieces(ids)
        assert p.get_special_tokens_mask(ids) == j.get_special_tokens_mask(ids)
    _same_tree(p(TEXTS, max_length, padding="longest"), j(TEXTS, max_length, padding="longest"))


def test_build_tokenizer_reads_a_vocab_file(tmp_path):
    path = tmp_path / "vocab.txt"
    path.write_text("".join(t + "\n" for t in ptok.make_test_vocab()))
    got, want = ptok.build_tokenizer(str(path)), jtok.build_tokenizer(str(path))
    assert isinstance(got, ptok.WordPieceTokenizer) and got.vocab == want.vocab
    with pytest.raises(FileNotFoundError):
        ptok.build_tokenizer(str(tmp_path / "missing"))


@pytest.mark.parametrize("strategy", ["uniform", "nlvl_uniform", "nlvl_rand", "rand",
                                      "headtail"])
@pytest.mark.parametrize("exact", [True, False])
def test_sample_frame_indices_match_jax(strategy, exact):
    for seed in range(4):
        for vlen, num_frm, start, end in ((30, 8, 0, None), (8, 8, 0, None), (100, 16, 10, 60),
                                          (5, 8, 0, None), (33, 3, 0, None), (64, 32, 0, None)):
            outs = []
            for mod in (psampling, jsampling):
                rng = np.random.default_rng(seed)
                try:
                    outs.append(mod.sample_frame_indices(vlen, num_frm, strategy, rng, start, end,
                                                         exact=exact))
                except Exception as e:  # the reference's resample-on-raise cases
                    outs.append(type(e))
            got, want = outs
            if isinstance(want, type):
                assert got is want
            else:
                np.testing.assert_array_equal(got, want)
                np.testing.assert_array_equal(psampling.fit_num_frames(got, num_frm),
                                              jsampling.fit_num_frames(want, num_frm))


@pytest.mark.parametrize("shape,size", [((3, 240, 320, 3), 256), ((2, 64, 64, 3), 32),
                                        ((2, 48, 64, 3), 40), ((2, 17, 29, 3), 64),
                                        ((1, 101, 37, 3), 23), ((2, 360, 480, 3), 256),
                                        ((1, 7, 5, 3), 224), ((1, 256, 341, 3), 256)])
def test_resize_shorter_side_matches_pillow(shape, size):
    """Up and down, at odd ratios and at 240 × 320 → 256 × 341, on random
    frames: equal to the JAX package's Pillow resize in every uint8 level
    (tolerance 0)."""
    frames = np.random.default_rng(sum(shape) + size).integers(0, 256, shape, dtype=np.uint8)
    got = ptransforms.resize_shorter_side(frames, size)
    want = jtransforms.resize_shorter_side(frames, size)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_crops_match_jax():
    frames = np.random.default_rng(0).integers(0, 256, (2, 40, 53, 3), dtype=np.uint8)
    np.testing.assert_array_equal(ptransforms.center_square_crop(frames, 32),
                                  jtransforms.center_square_crop(frames, 32))
    np.testing.assert_array_equal(
        ptransforms.random_square_crop(frames, 32, np.random.default_rng(3)),
        jtransforms.random_square_crop(frames, 32, np.random.default_rng(3)))


def test_read_video_matches_jax(tmp_path):
    clip = make_clip(np.random.default_rng(1), t=30, h=48, w=64, label=2)
    np.save(tmp_path / "v.npy", clip)
    np.savez(tmp_path / "v.npz", frames=clip)
    (tmp_path / "bad.npy").write_bytes(b"not a numpy file")
    cases = [dict(num_frm=8), dict(num_frm=8, height=32, width=32),
             dict(num_frm=4, start_time=1.0, end_time=2.5, fps=10),
             dict(num_frm=40), dict(num_frm=8, sampling="rand")]
    for name in ("v.npy", "v.npz", "bad.npy"):
        for kw in cases:
            got = pmedia.read_video(str(tmp_path / name), rng=np.random.default_rng(0), **kw)
            want = jmedia.read_video(str(tmp_path / name), rng=np.random.default_rng(0), **kw)
            if want is None:
                assert got is None
            else:
                np.testing.assert_array_equal(got, want)
    # a container path goes to the FFmpeg backend: a missing file reads as
    # None; where the decoder cannot be built, that raises
    if subprocess.run(["pkg-config", "--exists", "libavformat"]).returncode == 0:
        assert pmedia.read_video(str(tmp_path / "v.mp4"), 8) is None
    else:
        with pytest.raises(RuntimeError, match="failed to build"):
            pmedia.read_video(str(tmp_path / "v.mp4"), 8)
    with pytest.raises(AssertionError, match="fps"):
        pmedia.read_video(str(tmp_path / "v.npy"), 4, start_time=1.0, end_time=2.0)


def test_datalists_match_jax(tmp_path):
    rows = [{"video_id": 3, "caption": "a dog"}, {"vid_id": "x", "txt": "b", "ts": [0, 1]},
            {"clip_id": "c", "sentence": "s", "extra": [1, 2]}]
    (tmp_path / "a.json").write_text(json.dumps(rows))
    (tmp_path / "a.jsonl").write_text("".join(json.dumps(r) + "\n\n" for r in rows))
    for name in ("a.json", "a.jsonl"):
        assert pds.load_datalist(str(tmp_path / name)) == jds.load_datalist(str(tmp_path / name))
    try:
        import pandas
    except ImportError:
        with pytest.raises(ImportError, match="needs pandas"):
            pds.load_datalist(str(tmp_path / "train.pkl"))
    else:
        webvid = [{"videoid": 7 + i, "name": r.get("caption", "x"), "page_dir": "00"}
                  for i, r in enumerate(rows)]
        pandas.DataFrame(webvid).to_pickle(tmp_path / "train.pkl")
        got = pds.load_datalist(str(tmp_path / "train.pkl"))
        assert got == jds.load_datalist(str(tmp_path / "train.pkl")) and len(got) == 3
    with pytest.raises(ValueError):
        pds.load_datalist(str(tmp_path / "a.csv"))


def _retrieval_sets(root):
    ann, vid_dir, _ = write_video_dataset(root, n_videos=5, t=6, h=48, w=64)
    rows = jds.load_datalist(ann)
    rows.append({"vid_id": "vid001", "txt": "a second caption", "txt_id": 99})
    rows.append({"vid_id": "corrupt", "txt": "the blue dog", "txt_id": 100})
    with open(os.path.join(vid_dir, "corrupt.npy"), "wb") as f:
        f.write(b"not a numpy file")
    kw = dict(num_frm=4, resize_size=40, crop_size=32)
    return (pds.RetrievalEvalDataset(rows, vid_dir, **kw),
            jds.RetrievalEvalDataset(rows, vid_dir, **kw))


def test_retrieval_eval_dataset_matches_jax(tmp_path):
    """Texts, ids and ground truth equal; every video equal, the corrupt one
    a zero clip in both."""
    got, want = _retrieval_sets(str(tmp_path))
    assert got.texts == want.texts and got.video_ids == want.video_ids
    assert got.gt_txt_id2vid_id == want.gt_txt_id2vid_id and len(got) == len(want) == 6
    for i in range(len(want)):
        _same_tree(got.get_video(i), want.get_video(i))
    assert not got.get_video(5)["clip"].any()
    tok = jtok.WordPieceTokenizer(jtok.make_test_vocab())
    examples = [dict(got.get_video(i), caption=got.texts[i]["caption"]) for i in range(4)]
    for patchify in (False, True):
        _same_tree(pds.RetrievalCollator(tok, 12, patchify=patchify)(examples),
                   jds.RetrievalCollator(tok, 12, patchify=patchify)(examples))


@pytest.mark.parametrize("task", ["msrvtt_qa", "action"])
def test_qa_dataset_and_collator_match_jax(tmp_path, task):
    root = str(tmp_path)
    if task == "action":
        ann, vid_dir, rows = write_multichoice_qa_dataset(root, n=5, t=4, h=48, w=64,
                                                          n_options=3)
        ans2label = {}
    else:
        ann, vid_dir, rows, ans2label = write_qa_dataset(root, n=5, t=8, h=48, w=64)
    tok = jtok.WordPieceTokenizer(jtok.make_test_vocab())
    for return_label in (True, False):
        kw = dict(num_frm=4, resize_size=40, crop_size=32, is_train=False,
                  return_label=return_label, task_type=task)
        got = pds.VideoQADataset(pds.load_datalist(ann), vid_dir, ans2label, **kw)
        want = jds.VideoQADataset(jds.load_datalist(ann), vid_dir, ans2label, **kw)
        assert got.qid2data == want.qid2data and got.label2ans == want.label2ans
        items = [got[i] for i in range(len(got))]
        _same_tree(items, [want[i] for i in range(len(want))])
        col = dict(max_txt_len=40, return_label=return_label, task_type=task, n_options=3)
        _same_tree(pds.QACollator(tok, **col)(items), jds.QACollator(tok, **col)(items))


@pytest.mark.parametrize("shuffle,drop_last,shards,workers",
                         [(False, False, 1, 0), (True, True, 1, 0), (True, False, 3, 0),
                          (False, False, 1, 3), (True, False, 2, 2)])
def test_batch_loader_order_matches_jax(shuffle, drop_last, shards, workers):
    data = list(range(23))
    for shard in range(shards):
        kw = dict(batch_size=4, shuffle=shuffle, drop_last=drop_last, seed=5, num_shards=shards,
                  shard_id=shard, num_workers=workers)
        got = ploader.BatchLoader(data, list, **kw)
        want = jloader.BatchLoader(data, list, **kw)
        assert len(got) == len(want)
        for _ in range(2):  # two epochs: the shuffle's seed moves with the epoch
            assert list(got) == list(want)


def test_placeholder_loader_reads_nothing():
    """An sp rank > 0's loader (``placeholder=True``): as many batches as
    the reading loader, each an empty dict, and no item read."""

    class Unread:
        def __len__(self):
            return 23

        def __getitem__(self, i):
            raise AssertionError(f"item {i} read")

    kw = dict(batch_size=4, shuffle=True, seed=5, num_shards=2, shard_id=1, num_workers=2)
    got = ploader.BatchLoader(Unread(), list, placeholder=True, **kw)
    want = ploader.BatchLoader(list(range(23)), list, **kw)
    assert len(got) == len(want) == 3
    for _ in range(2):
        assert list(got) == [{}] * len(list(want))


def test_retrieval_training_dataset_matches_jax(tmp_path):
    """``RetrievalDataset`` in training (``rand`` frames, random crops, a
    caption drawn from a list, a failed decode resampling another row):
    every item of two passes equal to the JAX module's for the same seed,
    and the shuffled loader's collated batches too."""
    root = str(tmp_path)
    ann, vid_dir, _ = write_video_dataset(root, n_videos=5, t=8, h=48, w=64)
    rows = jds.load_datalist(ann)
    rows[1] = dict(rows[1], txt=["a first caption", "a second one", "a third"])
    rows.append({"vid_id": "missing", "txt": "no such clip"})
    kw = dict(num_frm=3, frm_sampling_strategy="rand", resize_size=40, crop_size=32, seed=7)
    got, want = pds.RetrievalDataset(rows, vid_dir, **kw), jds.RetrievalDataset(rows, vid_dir, **kw)
    for _ in range(2):
        _same_tree([got[i] for i in range(len(got))], [want[i] for i in range(len(want))])
    tok = jtok.WordPieceTokenizer(jtok.make_test_vocab())
    loaders = [mod.BatchLoader(ds, mod_ds.RetrievalCollator(tok, 12), 2, seed=3)
               for mod, mod_ds, ds in ((ploader, pds, got), (jloader, jds, want))]
    _same_tree(list(loaders[0]), list(loaders[1]))


@pytest.mark.parametrize("task", ["msrvtt_qa", "action"])
def test_qa_training_split_matches_jax(tmp_path, task):
    """``VideoQADataset`` with ``is_train`` (``rand`` frames over 2 clips'
    worth, random crops, labels) equal to the JAX module's for the same
    seed."""
    root = str(tmp_path)
    if task == "action":
        ann, vid_dir, _ = write_multichoice_qa_dataset(root, n=5, t=6, h=48, w=64, n_options=3)
        ans2label = {}
    else:
        ann, vid_dir, _, ans2label = write_qa_dataset(root, n=5, t=8, h=48, w=64)
    kw = dict(num_frm=4, frm_sampling_strategy="rand", resize_size=40, crop_size=32,
              is_train=True, seed=11, return_label=True, task_type=task)
    got = pds.VideoQADataset(pds.load_datalist(ann), vid_dir, ans2label, **kw)
    want = jds.VideoQADataset(jds.load_datalist(ann), vid_dir, ans2label, **kw)
    for _ in range(2):
        _same_tree([got[i] for i in range(len(got))], [want[i] for i in range(len(want))])


def test_infinite_iterator_matches_jax():
    """Three epochs and a half of a shuffled loader, epoch after epoch."""
    data = list(range(7))
    got = ploader.InfiniteIterator(ploader.BatchLoader(data, list, 2, seed=1))
    want = jloader.InfiniteIterator(jloader.BatchLoader(data, list, 2, seed=1))
    assert [next(got) for _ in range(11)] == [next(want) for _ in range(11)]


def _batches(n):
    for i in range(n):
        yield {"x": np.full((2, 3), i, np.int32), "ids": [f"q{i}"]}


def test_prefetcher_keeps_order_and_stages_on_the_cpu():
    """On the CPU the staging is ``torch.from_numpy`` of the arrays (the
    list entry dropped, as the JAX loop drops it); the batches come out in
    order, and the iterator ends."""
    import torch

    put = lambda b: ploader.stage_batch(b, torch.device("cpu"))  # noqa: E731
    pf = ploader.DevicePrefetcher(_batches(9), put, depth=2)
    got = [staged.wait() for staged in pf]
    assert [sorted(b) for b in got] == [["x"]] * 9
    assert [int(b["x"][0, 0]) for b in got] == list(range(9))
    assert all(b["x"].dtype == torch.int32 for b in got)
    pf.close()


def test_prefetcher_delivers_a_worker_error():
    def failing():
        yield from _batches(2)
        raise ValueError("bad clip")

    pf = ploader.DevicePrefetcher(failing(), lambda b: b, depth=4)
    assert [int(next(pf)["x"][0, 0]) for _ in range(2)] == [0, 1]
    with pytest.raises(RuntimeError, match="prefetch worker failed") as err:
        next(pf)
    assert isinstance(err.value.__cause__, ValueError)
    pf.close()


def test_prefetcher_close_drains_and_stops():
    """Closed while the producer blocks on a full queue over an endless
    iterator: the thread ends and nothing is left queued."""
    import itertools

    pf = ploader.DevicePrefetcher(({"i": i} for i in itertools.count()), lambda b: b, depth=2)
    assert next(pf) == {"i": 0}
    pf.close()
    assert not pf._thread.is_alive()
    assert pf._q.empty()
