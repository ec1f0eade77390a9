"""The pretraining data path against the JAX package, bit for bit.

MLM masking, entity pivots and random erase make the same numpy draws as
``alpro_tpu/data/masking.py`` for the same generator state; ``MetaLoader``
draws the same task sequence; ``mk_input_group``, both pretraining datasets
(the RandAugment, crop, flip and repeat) and ``PretrainCollator`` give equal
outputs for the same seed. The numpy RandAugment (``data/randaugment.py``)
equals Pillow — and so the JAX module, which calls Pillow — for every op at
levels 0-10 over random, gradient, flat and tiny images, and in sequences;
the bicubic resize and ``random_resized_crop`` equal Pillow's
``Image.BICUBIC``.
"""

import os

import numpy as np
import pytest
from PIL import Image

import alpro_tpu.data.datasets as jds
import alpro_tpu.data.loader as jloader
import alpro_tpu.data.masking as jmask
import alpro_tpu.data.randaugment as jra
import alpro_tpu.data.tokenization as jtok
import alpro_tpu.data.transforms as jtransforms
import alpro_tpu_torch.data.datasets as pds
import alpro_tpu_torch.data.loader as ploader
import alpro_tpu_torch.data.masking as pmask
import alpro_tpu_torch.data.randaugment as pra
import alpro_tpu_torch.data.tokenization as ptok
import alpro_tpu_torch.data.transforms as ptransforms
from fixtures import CAPTIONS, write_image_dataset, write_video_dataset
from test_torch_data import _same_tree


def _images():
    """Random, gradient, flat and tiny RGB images of several shapes."""
    rng = np.random.default_rng(0)
    out = []
    for H, W in ((32, 32), (48, 64), (37, 23), (64, 48), (5, 7)):
        out.append(rng.integers(0, 256, (H, W, 3), dtype=np.uint8))
        ramp = np.linspace(0, 1, H * W).reshape(H, W, 1) * np.array([200, 120, 40])
        out.append((ramp + rng.integers(0, 30, (H, W, 3))).astype(np.uint8))
    out.append(np.full((16, 16, 3), 77, np.uint8))
    out.append(rng.integers(0, 256, (1, 3, 3), dtype=np.uint8))
    out.append(rng.integers(0, 256, (2, 2, 3), dtype=np.uint8))
    return out


@pytest.mark.parametrize("op", sorted(jra.OPS))
def test_randaugment_op_equals_pillow(op):
    for level in range(11):
        for img in _images():
            want = np.asarray(jra.OPS[op](Image.fromarray(img), level))
            got = pra.OPS[op](img[None], level)[0]
            assert got.dtype == np.uint8 and got.shape == want.shape
            np.testing.assert_array_equal(got, want, err_msg=f"{op} level {level} {img.shape}")


def test_randaugment_op_on_a_clip_is_per_frame():
    """An op on (T, H, W, 3) frames equals it on each frame (the histogram
    ops read each frame's own histogram)."""
    clip = np.stack(_images()[:1] * 1 + [np.roll(_images()[0], 5, axis=1)])
    for op in ("AutoContrast", "Equalize", "Contrast", "Rotate", "Sharpness"):
        got = pra.OPS[op](clip, 7)
        for t in range(clip.shape[0]):
            np.testing.assert_array_equal(got[t], pra.OPS[op](clip[t:t + 1], 7)[0], err_msg=op)


@pytest.mark.parametrize("M", [5, 7, 10])
def test_augment_classes_match_jax(M):
    clip = np.random.default_rng(1).integers(0, 256, (3, 24, 40, 3), dtype=np.uint8)
    augs = sorted(jra.OPS)
    for seed in range(12):
        want = jra.TemporalConsistentRandomAugment(N=2, M=M, augs=augs,
                                                   rng=np.random.default_rng(seed))(clip)
        got = pra.TemporalConsistentRandomAugment(N=2, M=M, augs=augs,
                                                  rng=np.random.default_rng(seed))(clip)
        np.testing.assert_array_equal(got, want)
        want = jra.RandomAugment(N=3, M=M, p=0.3, augs=augs,
                                 rng=np.random.default_rng(seed))(clip[0])
        got = pra.RandomAugment(N=3, M=M, p=0.3, augs=augs,
                                rng=np.random.default_rng(seed))(clip[0])
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="unknown augmentation"):
        pra.RandomAugment(augs=["Blur"])


def test_bicubic_resize_equals_pillow():
    rng = np.random.default_rng(2)
    for _ in range(60):
        H, W = rng.integers(1, 70, 2)
        img = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
        oh, ow = rng.integers(1, 90, 2)
        want = np.asarray(Image.fromarray(img).resize((ow, oh), Image.BICUBIC))
        np.testing.assert_array_equal(ptransforms.resize(img, oh, ow, "bicubic"), want)


def test_random_resized_crop_and_flip_match_jax():
    for seed in range(20):
        img = np.random.default_rng(seed).integers(0, 256, (48 + seed, 64 - seed, 3),
                                                   dtype=np.uint8)
        for size in (32, 56):
            want = jtransforms.random_resized_crop(img, size, np.random.default_rng(seed))
            got = ptransforms.random_resized_crop(img, size, np.random.default_rng(seed))
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            ptransforms.random_hflip(img, np.random.default_rng(seed)),
            jtransforms.random_hflip(img, np.random.default_rng(seed)))
    # a 1:5 image takes the centred fallback with the aspect clamped
    thin = np.random.default_rng(3).integers(0, 256, (10, 50, 3), dtype=np.uint8)
    np.testing.assert_array_equal(
        ptransforms.random_resized_crop(thin, 16, np.random.default_rng(0), scale=(0.99, 1.0)),
        jtransforms.random_resized_crop(thin, 16, np.random.default_rng(0), scale=(0.99, 1.0)))


def _tokenizers():
    vocab = jtok.make_test_vocab()
    return ptok.WordPieceTokenizer(vocab), jtok.WordPieceTokenizer(vocab)


def test_masking_matches_jax():
    ptk, jtk = _tokenizers()
    enc = jtk(CAPTIONS * 3, max_length=10)
    ids = np.asarray(enc["input_ids"], np.int32)
    for seed in range(5):
        got = pmask.mask_batch_text_tokens(ids, ptk, rng=np.random.default_rng(seed))
        want = jmask.mask_batch_text_tokens(ids, jtk, rng=np.random.default_rng(seed))
        _same_tree(got, want)
        assert (got[1] != -100).any()
        ent2id = {"dog": 0, "cat": 1, "ball": 2}
        _same_tree(pmask.select_text_pivots(ids, ptk, ent2id, 0.7, np.random.default_rng(seed)),
                   jmask.select_text_pivots(ids, jtk, ent2id, 0.7, np.random.default_rng(seed)))
    frames = np.random.default_rng(9).integers(0, 256, (2, 64, 48, 3), dtype=np.uint8)
    for seed in range(8):
        _same_tree(pmask.random_erase(frames, 16, rng=np.random.default_rng(seed)),
                   jmask.random_erase(frames, 16, rng=np.random.default_rng(seed)))


def test_meta_loader_and_groups_match_jax():
    class Sized:
        def __init__(self, n, tag):
            self.n, self.tag = n, tag

        def __len__(self):
            return self.n

        def __iter__(self):
            return iter(f"{self.tag}{i}" for i in range(self.n))

    loaders = {"video": Sized(3, "v"), "image": Sized(5, "i"), "more": Sized(1, "m")}
    for accum in (1, 3):
        got = ploader.MetaLoader(loaders, accum_steps=accum, seed=7)
        want = jloader.MetaLoader(loaders, accum_steps=accum, seed=7)
        assert [next(got) for _ in range(40)] == [next(want) for _ in range(40)]
    with pytest.raises(ValueError, match="zero weight"):
        ploader.MetaLoader({"empty": Sized(0, "e")})
    pairs = [(k % 3, f"t{k}") for k in range(10)]
    for is_train in (True, False):
        assert pds.mk_input_group(pairs, 2, is_train, np.random.default_rng(1)) == \
            jds.mk_input_group(pairs, 2, is_train, np.random.default_rng(1))


def test_pretrain_video_dataset_matches_jax(tmp_path):
    ann, vid_dir, _ = write_video_dataset(str(tmp_path), n_videos=5, t=6, h=48, w=64)
    rows = jds.load_datalist(ann)
    for is_train in (True, False):
        kw = dict(num_frm=4, frm_sampling_strategy="headtail", resize_size=40, crop_size=32,
                  seed=3, is_train=is_train)
        got, want = pds.PretrainVideoDataset(rows, vid_dir, **kw), \
            jds.PretrainVideoDataset(rows, vid_dir, **kw)
        assert (got.randaug is None) == (want.randaug is None) == (not is_train)
        for i in (0, 3, 1, 4, 0):
            _same_tree(got[i], want[i])


def test_pretrain_image_dataset_and_collator_match_jax(tmp_path):
    root = str(tmp_path)
    ann, img_dir, _ = write_image_dataset(root, n=6, h=48, w=56)
    rows = jds.load_datalist(ann) + [{"vid_id": "missing", "txt": "a dog"}]
    ptk, jtk = _tokenizers()
    for is_train in (True, False):
        kw = dict(num_frm=3, resize_size=40, crop_size=32, seed=5, is_train=is_train)
        got, want = pds.PretrainImageDataset(rows, img_dir, **kw), \
            jds.PretrainImageDataset(rows, img_dir, **kw)
        items = []
        for i in (0, 6, 2, 5, 1, 6):  # row 6 has no file: another row is drawn
            a, b = got[i], want[i]
            _same_tree(a, b)
            assert a["clip"].shape == (3, 32, 32, 3) and (a["clip"] == a["clip"][:1]).all()
            items.append(a)
        for mlm, mpm in ((True, True), (False, False)):
            _same_tree(pds.PretrainCollator(ptk, 10, mlm=mlm, mpm=mpm, seed=2)(items),
                       jds.PretrainCollator(jtk, 10, mlm=mlm, mpm=mpm, seed=2)(items))
    batch = pds.PretrainCollator(ptk, 10, seed=2)(items)
    assert batch["type"] == "image" and batch["mpm_mask"].shape == (6, 2, 2)
    with open(os.path.join(img_dir, "jpg0.jpg"), "wb") as f:
        f.write(b"\xff\xd8")
    with pytest.raises(NotImplementedError, match="A17"):
        pds.PretrainImageDataset([{"vid_id": "jpg0.jpg", "txt": "x"}], img_dir)[0]
